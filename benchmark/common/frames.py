"""A stream's frames, drawn from the run's seed on the device in a few
large calls (``textured_image``'s look: smooth blobs plus noise), then
handed to the program as the host images a camera would give."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BLOB = 40  # pixels a side of the smooth blobs


def frames(seed: int, n: int, h: int, w: int, dev) -> np.ndarray:
    """[n, h, w, 3] uint8 RGB."""
    g = torch.Generator(device=dev).manual_seed(seed)
    low = torch.rand((n, 3, h // BLOB + 1, w // BLOB + 1), generator=g,
                     device=dev) * 255
    img = F.interpolate(low, scale_factor=BLOB, mode="nearest")[..., :h, :w]
    img = img + 20 * torch.randn(img.shape, generator=g, device=dev)
    img = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    return np.ascontiguousarray(img.cpu().numpy())
