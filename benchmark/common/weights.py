"""Seeded random weights, made on the device in two large draws (after
``chip_smoke.py::synthetic_state_dict`` and
``synthetic_yolact_state_dict``, whose schemes these are): one normal and
one uniform vector as long as all the floating tensors together, from a
``torch.Generator`` on ``dev`` seeded with the run's seed; each tensor
takes its slice, scaled by its rule."""
from __future__ import annotations

import math

import torch


def draws(shapes: dict, seed: int, dev) -> tuple:
    """(normal, uniform) flat vectors and each name's offset in them."""
    offsets, total = {}, 0
    for name, shape in shapes.items():
        offsets[name] = total
        total += math.prod(shape)
    g = torch.Generator(device=dev).manual_seed(seed)
    normal = torch.randn(total, generator=g, device=dev)
    uniform = torch.rand(total, generator=g, device=dev)
    return normal, uniform, offsets


def synthetic_state_dict(model: torch.nn.Module, seed: int, dev,
                         rule) -> dict:
    """Every floating tensor of ``model``'s state dict from the seed, on
    ``dev``: ``rule(name, shape)`` -> ("uniform", lo, hi) or ("normal",
    scale); integer tensors (BatchNorm's counters) are zeros."""
    state = model.state_dict()
    shapes = {k: tuple(v.shape) for k, v in state.items()
              if v.is_floating_point()}
    normal, uniform, offsets = draws(shapes, seed, dev)
    sd = {}
    for k, v in state.items():
        if k not in shapes:
            sd[k] = torch.zeros_like(v, device=dev)
            continue
        n, off = math.prod(shapes[k]), offsets[k]
        kind, *args = rule(k, shapes[k])
        if kind == "uniform":
            lo, hi = args
            t = uniform[off:off + n] * (hi - lo) + lo
        else:
            t = normal[off:off + n] * args[0]
        sd[k] = t.reshape(shapes[k]).clone()
    return sd


def fan_scale(shape) -> float:
    """N(0, 1/fan_in)'s standard deviation for a weight of ``shape``."""
    return math.prod(shape[1:]) ** -0.5
