"""Load maskrcnn-benchmark checkpoints (port of
``tpuseg/weights/detectron_map.py``).

The port's modules carry the upstream names, so loading is the port's
checkpoint reader (``weights/torch_io.py``: torch zip or legacy files, or a
plain pickle of numpy arrays; the ``state_dict``/``model``/``weights``/
``params`` containers unwrapped, nested dicts flattened), ``module.``
stripping and ``load_state_dict(strict=True)``; the only edits
are three upstream quirks:
  * the anchor generator's ``cell_anchors`` buffers are dropped: anchors
    are recomputed from the config (``make_anchors_np``);
  * FrozenBatchNorm2d mean/var that some Caffe2 conversions omit (already
    folded) default to 0 / 1;
  * a C4 checkpoint may carry res5 twice: upstream's CombinedROIHeads
    hands the box head's feature extractor to the mask head
    (SHARE_BOX_FEATURE_EXTRACTOR), so its ``state_dict`` also holds
    ``roi_heads.mask.feature_extractor.*``. The port's C4 model has one
    copy, the box head's; the other is dropped once it is checked to be
    equal to it.

The same function loads Mask R-CNN and Faster R-CNN (FPN or C4) and
RetinaNet checkpoints: the model passed in decides which keys must be
there.
"""
from __future__ import annotations

import torch
from torch import nn

from tpuseg_torch.nn.layers import FrozenBatchNorm2d
from tpuseg_torch.weights.torch_io import flatten_state_dict, load_torch_file

_DROP_PREFIXES = ("rpn.anchor_generator.",)
_SHARED = "roi_heads.mask.feature_extractor."
_BOX = "roi_heads.box.feature_extractor."


def load_detectron_weights(path: str, model: nn.Module) -> nn.Module:
    """Load an upstream ``.pth`` into ``model`` (strict); returns ``model``."""
    obj = flatten_state_dict(load_torch_file(path))
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in obj.items()}
    sd = {k: v for k, v in sd.items() if not k.startswith(_DROP_PREFIXES)}
    own = model.state_dict().keys()
    for k in [k for k in sd if k.startswith(_SHARED) and k not in own]:
        # a key without a box twin (another model's mask head) is left to
        # the strict load, which names it
        twin = _BOX + k[len(_SHARED):]
        if twin not in sd:
            continue
        if not torch.equal(sd[twin], sd[k]):
            raise ValueError(f"{k}: the mask head's copy of the shared box "
                             f"feature extractor differs from {twin}")
        del sd[k]
    for name, m in model.named_modules():
        if isinstance(m, FrozenBatchNorm2d):
            c = sd[f"{name}.weight"].shape[0]
            sd.setdefault(f"{name}.running_mean", torch.zeros(c))
            sd.setdefault(f"{name}.running_var", torch.ones(c))
    model.load_state_dict(sd, strict=True)
    return model
