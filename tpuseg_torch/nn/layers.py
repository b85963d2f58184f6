"""Layers the port needs beyond ``torch.nn`` (port of ``tpuseg/nn/layers.py``).

Max pooling needs no wrapper: ``F.max_pool2d`` pads with -inf, as the JAX
``max_pool2d`` (``reduce_window`` with a -inf init) does.
"""
from __future__ import annotations

import torch
from torch import nn


class FrozenBatchNorm2d(nn.Module):
    """maskrcnn-benchmark FrozenBatchNorm2d: an affine map with folded stats.

    The four tensors are buffers, named as upstream, so a detectron
    checkpoint loads with ``load_state_dict(strict=True)``. eps is 0: the
    Caffe2-origin weights already fold it into ``running_var``. The folding
    order (scale first, then bias) is the JAX ``frozen_batch_norm``'s.
    """

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = self.weight * self.running_var.rsqrt()
        bias = self.bias - self.running_mean * scale
        return x * scale[None, :, None, None] + bias[None, :, None, None]
