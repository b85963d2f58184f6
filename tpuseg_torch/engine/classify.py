"""ViT classification predictor (port of ``tpuseg/engine/classify.py``;
ViT.jittor's test/infer entry point).

:class:`ViTClassifier` resizes an image to the model's square input on the
host (``data/image_io.py::resize_bilinear_u8``, the port's twin of
``cv2.resize(INTER_LINEAR)``), then preprocesses and runs the model on
``device`` and returns the top-k classes. :func:`load_vit_weights` reads a
``.npz`` as google-research's format and anything else as a torch state
dict with jeonsworld's keys (as the JAX package does: so the npz that
``tools/vit_train.py`` writes is not read here; ``weights/npz_io.py``
reads that one).
"""
from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.data.image_io import resize_bilinear_u8
from tpuseg_torch.engine.config import ConfigNode, get_config
from tpuseg_torch.nn import vit as vit_nn
from tpuseg_torch.ops.preprocess import vit_preprocess


def config_to_vit(cfg: ConfigNode) -> vit_nn.ViTConfig:
    return vit_nn.ViTConfig(
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
        num_heads=cfg.num_heads, mlp_dim=cfg.mlp_dim,
        num_classes=cfg.num_classes)


def build_vit(cfg: vit_nn.ViTConfig, state_dict: dict | None = None,
              weights: str | None = None) -> vit_nn.VisionTransformer:
    """A CPU model from a state_dict, a checkpoint (``load_vit_weights``)
    or random weights from a ``torch.Generator`` seeded with 0."""
    if weights:
        state_dict = load_vit_weights(weights, cfg)
    model = vit_nn.build_model(
        cfg, None if state_dict else torch.Generator().manual_seed(0))
    if state_dict:
        model.load_state_dict(state_dict, strict=True)
    return model


class ViTClassifier:
    """ViT inference on ``device`` for a named preset (``get_config``)."""

    def __init__(self, config_name: str = "vit_b16_config",
                 weights: str | None = None, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but CUDA is unavailable")
        self.cfg = get_config(config_name).freeze()
        self.vit_cfg = config_to_vit(self.cfg)
        self.model = build_vit(self.vit_cfg, weights=weights).to(
            self.device).eval()

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        """uint8 RGB [B, H, W, 3] on the device -> logits [B, classes]."""
        return self.model(vit_preprocess(images_u8,
                                         size=self.vit_cfg.image_size))

    def run_on_image(self, image_rgb_u8: np.ndarray, top_k: int = 5):
        """uint8 RGB HWC image -> (top_k class ids, probabilities), the
        higher-scored first, ties to the lower id."""
        s = self.vit_cfg.image_size
        if image_rgb_u8.shape[:2] != (s, s):
            image_rgb_u8 = resize_bilinear_u8(image_rgb_u8, s, s)
        with torch.inference_mode():
            logits = self.forward(
                torch.from_numpy(np.ascontiguousarray(image_rgb_u8))[None]
                .to(self.device))
            probs = torch.softmax(logits, -1)[0]
            top_p, top_i = torch.sort(probs, descending=True, stable=True)
            return top_i[:top_k].cpu().numpy(), top_p[:top_k].cpu().numpy()


def load_vit_weights(path: str, cfg: vit_nn.ViTConfig) -> dict:
    """A ``.npz`` (google-research's format) or a torch checkpoint
    (jeonsworld's keys) -> the port's state_dict."""
    from tpuseg_torch.weights import vit_map
    from tpuseg_torch.weights.torch_io import (flatten_state_dict,
                                               load_torch_file)

    if path.endswith(".npz"):
        with np.load(path) as npz:
            return vit_map.from_npz(dict(npz), cfg)
    return vit_map.from_torch_state(flatten_state_dict(load_torch_file(path)),
                                    cfg)
