"""Vision Transformer (port of ``tpuseg/nn/vit.py``; ViT.jittor).

A 16x16 stride-16 conv patch embedding, the class token and learned
position embeddings, pre-LN encoder blocks (multi-head self-attention and
an exact-erf GELU MLP, LayerNorm eps 1e-6 with the biased variance), a
final LayerNorm and a linear head on the class token.

The modules carry jeonsworld/ViT-pytorch's state_dict keys
(``transformer.embeddings.patch_embeddings``,
``transformer.encoder.layer.{i}.attn.query``, ``attention_norm``,
``ffn.fc1``, ``transformer.encoder.encoder_norm``, ``head``), so such a
``.pth`` loads with plain ``load_state_dict``. Attention is the JAX
package's explicit form, two batched matrix products around a softmax
(it computes it outside any Pallas kernel).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    num_classes: int = 1000
    ln_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


VIT_B16 = ViTConfig()
VIT_L16 = ViTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                    mlp_dim=4096)


class Embeddings(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.patch_embeddings = nn.Conv2d(3, d, cfg.patch_size,
                                          stride=cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.position_embeddings = nn.Parameter(
            torch.zeros(1, cfg.num_patches + 1, d))

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.patch_embeddings(images).flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(x.shape[0], -1, -1)
        return torch.cat([cls, x], dim=1) + self.position_embeddings


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        d = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.out = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        hd = d // self.num_heads

        def heads(lin):  # [B, N, D] -> [B, H, N, hd]
            return lin(x).reshape(b, n, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.query), heads(self.key), heads(self.value)
        # a true division by sqrt(hd), as the JAX package's
        scale = torch.tensor(math.sqrt(hd), dtype=x.dtype, device=x.device)
        attn = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / scale,
                             dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, d)
        return self.out(out)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.mlp_dim)
        self.fc2 = nn.Linear(cfg.mlp_dim, cfg.hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.attention_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)
        self.ffn_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)
        self.attn = Attention(cfg)
        self.ffn = Mlp(cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.attention_norm(x))
        return x + self.ffn(self.ffn_norm(x))


class Encoder(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.layer = nn.ModuleList(Block(cfg) for _ in range(cfg.num_layers))
        self.encoder_norm = nn.LayerNorm(cfg.hidden_size, eps=cfg.ln_eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.layer:
            x = blk(x)
        return self.encoder_norm(x)


class Transformer(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.encoder(self.embeddings(images))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: ViTConfig = VIT_B16):
        super().__init__()
        self.cfg = cfg
        self.transformer = Transformer(cfg)
        self.head = nn.Linear(cfg.hidden_size, cfg.num_classes)

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 3, H, W] normalised -> the class token's embedding
        after the final LayerNorm [B, hidden]."""
        return self.transformer(images)[:, 0]

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, 3, H, W] normalised -> logits [B, num_classes]."""
        return self.head(self.features(images))


def build_model(cfg: ViTConfig = VIT_B16,
                generator: torch.Generator | None = None) -> VisionTransformer:
    """A CPU model in eval mode: random weights from ``generator`` if one
    is given (the JAX ``init_params``'s kinds: linear weights Xavier
    uniform, the patch embedding N(0, 2/fan_in), position embeddings
    N(0, 0.02^2), the class token, biases and LayerNorm shifts 0, LayerNorm
    scales 1), otherwise uninitialised storage for ``load_state_dict``."""
    with torch.device("meta"):
        model = VisionTransformer(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        with torch.no_grad():
            for name, t in model.named_parameters():
                if t.ndim == 4:
                    t.normal_(0.0, (2.0 / t[0].numel()) ** 0.5,
                              generator=generator)
                elif t.ndim == 2:  # Linear [out, in]
                    bound = (6.0 / sum(t.shape)) ** 0.5
                    t.uniform_(-bound, bound, generator=generator)
                elif name.endswith("position_embeddings"):
                    t.normal_(0.0, 0.02, generator=generator)
                elif name.endswith("norm.weight"):
                    t.fill_(1.0)
                else:
                    t.zero_()
    return model.eval()
