"""Single-image ViT classification on the PyTorch port (ViT.jittor
test/infer; the port's copy of ``tools/vit_infer.py``).

    python -m tpuseg_torch.tools.vit_infer --image=path.jpg
        [--weights=vit.pth|vit.npz] [--config=vit_b16_config] [--top_k=5]
        [--device=cuda]

Without ``--weights`` the model has random weights (seed 0).
"""
import argparse


def main(argv=None) -> tuple:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--image", required=True)
    ap.add_argument("--weights", default=None)
    ap.add_argument("--config", default="vit_b16_config")
    ap.add_argument("--top_k", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from tpuseg_torch.data.image_io import load_image_rgb
    from tpuseg_torch.engine.classify import ViTClassifier

    clf = ViTClassifier(args.config, args.weights, device=args.device)
    ids, probs = clf.run_on_image(load_image_rgb(args.image), args.top_k)
    for rank, (i, p) in enumerate(zip(ids, probs), 1):
        print(f"top{rank}: class {int(i)}  prob {float(p):.4f}")
    return ids, probs


if __name__ == "__main__":
    main()
