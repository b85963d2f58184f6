"""Mask R-CNN single-image demo on the PyTorch port.

    python -m tpuseg_torch.tools.maskrcnn_infer --image=in.jpg --device=cuda
        [--weights=e2e_mask_rcnn_R_50_FPN_1x.pth] [--confidence_threshold=0.5]
        [--min_image_size=800] [--out=out.jpg]

Without ``--weights`` the model has random weights (seed 0).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--confidence_threshold", type=float, default=0.5)
    ap.add_argument("--min_image_size", type=int, default=800)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from tpuseg_torch.data.image_io import (draw_detections, load_image_bgr,
                                           save_image_bgr)
    from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor

    demo = MaskRCNNPredictor(weights=args.weights, device=args.device,
                             confidence_threshold=args.confidence_threshold,
                             min_image_size=args.min_image_size)
    img = load_image_bgr(args.image)
    top = demo.select_top_predictions(demo.run_on_bgr_image(img))
    print(f"{len(top['scores'])} detections above {args.confidence_threshold}")
    for i in range(len(top["scores"])):
        x1, y1, x2, y2 = top["boxes"][i]
        print(f"  class {int(top['classes'][i]):3d} score "
              f"{top['scores'][i]:.3f} box [{x1:.1f},{y1:.1f},{x2:.1f},{y2:.1f}]"
              f" mask_px {int(top['masks'][i].sum())}")
    if args.out:
        vis = draw_detections(img, top["boxes"], top["masks"], alpha=0.45)
        save_image_bgr(args.out, vis)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
