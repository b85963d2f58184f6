"""YOLACT / YOLACT++ single-image demo on the PyTorch port.

    python -m tpuseg_torch.tools.yolact_infer --config=yolact_plus_resnet50
        --image=in.jpg [--weights=yolact_plus_resnet50_54_800000.pth]
        [--device=cuda] [--score_threshold=0.3] [--out=out.jpg]

Without ``--weights`` the model has random weights (seed 0).
"""
import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="yolact_plus_resnet50")
    ap.add_argument("--image", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--score_threshold", type=float, default=0.3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np

    from tpuseg_torch.configs.presets import yolact_model_config
    from tpuseg_torch.data.image_io import load_image_bgr, save_image_bgr
    from tpuseg_torch.engine.yolact_engine import YolactPredictor

    pred = YolactPredictor(yolact_model_config(args.config),
                           weights=args.weights, device=args.device)
    img = load_image_bgr(args.image)
    res = pred.predict_images([np.ascontiguousarray(img[:, :, ::-1])],
                              args.score_threshold)[0]
    print(f"{len(res['scores'])} detections above {args.score_threshold}")
    for i in range(len(res["scores"])):
        x1, y1, x2, y2 = res["boxes"][i]
        extra = (f" mask_score {res['mask_scores'][i]:.3f}"
                 if "mask_scores" in res else "")
        print(f"  class {int(res['classes'][i]):3d} score "
              f"{res['scores'][i]:.3f}{extra} box [{x1:.0f},{y1:.0f},"
              f"{x2:.0f},{y2:.0f}] mask_px {int(res['masks'][i].sum())}")
    if args.out:
        vis = img.copy()
        rng = np.random.default_rng(0)
        for m in res["masks"].astype(bool):
            color = rng.integers(60, 255, 3)
            vis[m] = (0.55 * vis[m] + 0.45 * color).astype(np.uint8)
        save_image_bgr(args.out, vis)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
