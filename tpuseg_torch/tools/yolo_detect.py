"""YOLOv3 single-image detection on the PyTorch port (yolo.jittor
detect.py; the port's copy of ``tools/yolo_detect.py``).

    python -m tpuseg_torch.tools.yolo_detect --image=in.jpg
        [--weights=yolov3.weights] [--img_size=416] [--conf_thres=0.5]
        [--nms_thres=0.45] [--out=out.jpg] [--device=cuda]

``--weights``: a darknet ``.weights`` file or the JAX package's npz
params; without it the model has random weights (seed 0). ``--out`` draws
the boxes and "class:score" labels.
"""
import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--img_size", type=int, default=416)
    ap.add_argument("--conf_thres", type=float, default=0.5)
    ap.add_argument("--nms_thres", type=float, default=0.45)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from tpuseg_torch.data.image_io import (draw_detections, load_image_rgb,
                                            save_image_bgr)
    from tpuseg_torch.engine.yolo_engine import YoloPredictor
    from tpuseg_torch.models.yolov3 import YoloV3Config

    cfg = YoloV3Config(input_size=args.img_size, conf_thresh=args.conf_thres,
                       nms_thresh=args.nms_thres)
    pred = YoloPredictor(cfg, weights=args.weights, device=args.device)
    img = load_image_rgb(args.image)
    h, w = img.shape[:2]
    dets = pred.run_batch(img[None], np.asarray([[h, w]], np.int32))
    valid = dets["valid"][0]
    n = int(valid.sum())  # the valid detections come first, by score
    boxes = pred.unletterbox(dets["boxes"][0][:n], h, w)
    scores, classes = dets["scores"][0][:n], dets["classes"][0][:n]
    print(f"{n} detections (conf > {args.conf_thres})")
    for i in range(n):
        x1, y1, x2, y2 = boxes[i]
        print(f"  class {int(classes[i]):3d}  conf {scores[i]:.3f}  "
              f"box [{x1:.1f}, {y1:.1f}, {x2:.1f}, {y2:.1f}]")
    if args.out and n:
        vis = draw_detections(
            np.ascontiguousarray(img[:, :, ::-1]), boxes, [],
            [f"{int(c)}:{s:.2f}" for c, s in zip(classes, scores)])
        save_image_bgr(args.out, vis)
        print(f"wrote {args.out}")
    return {"boxes": boxes, "scores": scores, "classes": classes}


if __name__ == "__main__":
    main()
