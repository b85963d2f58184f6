"""Load maskrcnn-benchmark checkpoints (port of
``tpuseg/weights/detectron_map.py``).

The port's modules carry the upstream names, so loading is the port's
checkpoint reader (``weights/torch_io.py``: torch zip or legacy files, or a
plain pickle of numpy arrays; the ``state_dict``/``model``/``weights``/
``params`` containers unwrapped, nested dicts flattened), ``module.``
stripping and ``load_state_dict(strict=True)``; the only edits
are two upstream quirks:
  * the anchor generator's ``cell_anchors`` buffers are dropped: anchors
    are recomputed from the config (``make_anchors_np``);
  * FrozenBatchNorm2d mean/var that some Caffe2 conversions omit (already
    folded) default to 0 / 1.
"""
from __future__ import annotations

import torch
from torch import nn

from tpuseg_torch.nn.layers import FrozenBatchNorm2d
from tpuseg_torch.weights.torch_io import flatten_state_dict, load_torch_file

_DROP_PREFIXES = ("rpn.anchor_generator.",)


def load_detectron_weights(path: str, model: nn.Module) -> nn.Module:
    """Load an upstream ``.pth`` into ``model`` (strict); returns ``model``."""
    obj = flatten_state_dict(load_torch_file(path))
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in obj.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith(_DROP_PREFIXES)}
    for name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm2d):
            c = sd[f"{name}.weight"].shape[0]
            sd.setdefault(f"{name}.running_mean", torch.zeros(c))
            sd.setdefault(f"{name}.running_var", torch.ones(c))
    model.load_state_dict(sd, strict=True)
    return model
