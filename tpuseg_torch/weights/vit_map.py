"""ViT checkpoints -> the port's state_dict (the port's copy of
``tpuseg/weights/vit_map.py``).

The two formats ViT.jittor reads:
  * torch state dicts with jeonsworld/ViT-pytorch's keys
    (``transformer.encoder.layer.{i}.attn.query.weight`` ...), which are
    the port's own module names: :func:`from_torch_state` takes the model's
    tensors from them;
  * google-research vision_transformer ``.npz`` files
    (``Transformer/encoderblock_{i}/MultiHeadDotProductAttention_1/...``):
    :func:`from_npz` reshapes the per-head kernels and transposes [in, out]
    to [out, in] and the patch kernel HWIO to OIHW.
"""
from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.nn.vit import ViTConfig

_LAYER = "transformer.encoder.layer.{}."


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))


def _keys(cfg: ViTConfig) -> list:
    """The model's state_dict keys."""
    top = ["transformer.embeddings.patch_embeddings.weight",
           "transformer.embeddings.patch_embeddings.bias",
           "transformer.embeddings.cls_token",
           "transformer.embeddings.position_embeddings",
           "transformer.encoder.encoder_norm.weight",
           "transformer.encoder.encoder_norm.bias", "head.weight",
           "head.bias"]
    block = [f"{m}.{p}" for m in ("attention_norm", "ffn_norm", "attn.query",
                                  "attn.key", "attn.value", "attn.out",
                                  "ffn.fc1", "ffn.fc2")
             for p in ("weight", "bias")]
    return top + [_LAYER.format(i) + k for i in range(cfg.num_layers)
                  for k in block]


def from_torch_state(flat: dict, cfg: ViTConfig) -> dict:
    """A jeonsworld/ViT-pytorch state dict -> the port's state_dict (f32
    tensors); keys the model does not have are ignored, a missing one
    raises KeyError."""
    return {k: torch.as_tensor(flat[k]).float().contiguous().clone()
            for k in _keys(cfg)}


def from_npz(npz: dict, cfg: ViTConfig) -> dict:
    """A google-research vision_transformer npz -> the port's state_dict."""
    def g(k):
        return np.asarray(npz[k], np.float32)

    d = cfg.hidden_size
    sd = {
        "transformer.embeddings.patch_embeddings.weight":
            _t(g("embedding/kernel").transpose(3, 2, 0, 1)),
        "transformer.embeddings.patch_embeddings.bias": _t(g("embedding/bias")),
        "transformer.embeddings.cls_token": _t(g("cls")),
        "transformer.embeddings.position_embeddings":
            _t(g("Transformer/posembed_input/pos_embedding")),
        "transformer.encoder.encoder_norm.weight":
            _t(g("Transformer/encoder_norm/scale")),
        "transformer.encoder.encoder_norm.bias":
            _t(g("Transformer/encoder_norm/bias")),
        "head.weight": _t(g("head/kernel").T),
        "head.bias": _t(g("head/bias")),
    }
    for i in range(cfg.num_layers):
        src, dst = f"Transformer/encoderblock_{i}/", _LAYER.format(i)
        for s, t in (("LayerNorm_0", "attention_norm"),
                     ("LayerNorm_2", "ffn_norm")):
            sd[f"{dst}{t}.weight"] = _t(g(f"{src}{s}/scale"))
            sd[f"{dst}{t}.bias"] = _t(g(f"{src}{s}/bias"))
        mha = src + "MultiHeadDotProductAttention_1/"
        for name in ("query", "key", "value", "out"):
            w = g(f"{mha}{name}/kernel")  # [D, H, hd], out's [H, hd, D]
            w = w.reshape(-1, d) if name == "out" else w.reshape(d, -1)
            sd[f"{dst}attn.{name}.weight"] = _t(w.T)
            sd[f"{dst}attn.{name}.bias"] = _t(
                g(f"{mha}{name}/bias").reshape(-1))
        for j, fc in enumerate(("fc1", "fc2")):
            sd[f"{dst}ffn.{fc}.weight"] = _t(
                g(f"{src}MlpBlock_3/Dense_{j}/kernel").T)
            sd[f"{dst}ffn.{fc}.bias"] = _t(g(f"{src}MlpBlock_3/Dense_{j}/bias"))
    return sd
