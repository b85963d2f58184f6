"""Upstream Pose2Seg checkpoints (``last.pkl``) -> the port's state_dict
(the port's copy of ``tpuseg/engine/pose2seg_engine.py::
load_pose2seg_weights`` and ``pose2seg_from_torch``, with their checks).

The port's module names are the inlined layout of upstream's names
(``backbone.conv1``, ``backbone.layer1.0.conv1``, ``backbone.toplayer``,
``segnet.conv1``, ``segnet.layers.i``, ``segnet.conv2``); the loader also
takes the ResNet nested under ``backbone.resnet.``, ``backbone.resnet50.``
or ``backbone.backbone.``, the FPN under ``backbone.fpn.``, a ``module.``
prefix, the SegModule's stem as ``stem.{0,1}`` or ``conv_in``/``bn_in``
and its units in any container, and maps them onto those names.
"""
from __future__ import annotations

import re
from dataclasses import replace

import torch

from tpuseg_torch.models import pose2seg as P2S
from tpuseg_torch.weights.torch_io import flatten_state_dict, load_torch_file

RESNET_PREFIXES = ("backbone.", "backbone.resnet.", "backbone.resnet50.",
                   "backbone.backbone.")
FPN_PREFIXES = ("backbone.", "backbone.fpn.")
FPN_CONVS = ("toplayer", "latlayer1", "latlayer2", "latlayer3", "smooth1",
             "smooth2", "smooth3")
OPTIONAL_FPN = ("smooth1", "smooth2")  # not on the P2 path; zeros if absent
STEM_CONVS = ("segnet.conv1.weight", "segnet.stem.0.weight",
              "segnet.conv_in.weight")
_BN = ("weight", "bias", "running_mean", "running_var")


def load_pose2seg_weights(path: str, cfg: P2S.Pose2SegConfig) -> tuple:
    """Read a Pose2Seg checkpoint (any file and container that
    ``weights/torch_io.py`` reads) -> (state_dict, cfg'), see
    :func:`pose2seg_from_torch`; or the JAX package's npz params ->
    (state_dict, cfg), the config unchanged, as the JAX loader returns
    it."""
    if path.endswith(".npz"):
        from tpuseg_torch.weights.from_jax import pose2seg_state_dict_from_jax
        from tpuseg_torch.weights.npz_io import load_params_npz

        return pose2seg_state_dict_from_jax(load_params_npz(path)), cfg
    return pose2seg_from_torch(flatten_state_dict(load_torch_file(path)), cfg)


def pose2seg_from_torch(flat: dict, cfg: P2S.Pose2SegConfig) -> tuple:
    """An upstream Pose2Seg state dict -> (the port's state_dict, cfg'),
    strictly: every ``backbone.*`` and ``segnet.*`` tensor is mapped
    (``num_batches_tracked`` excepted, which is 0 where absent) or this
    raises listing the leftovers, and every tensor of the model is found
    or this raises listing the missing. cfg' has ``cat_skeleton`` from the
    SegModule's input channels and ``seg_units`` from the units found."""
    if any(k.startswith("module.") for k in flat):
        flat = {k.removeprefix("module."): v for k, v in flat.items()}
    out, consumed = {}, set()

    def take(src: str, dst: str) -> None:
        consumed.add(src)
        out[dst] = flat[src]

    def conv(src: str, dst: str) -> None:
        take(f"{src}.weight", f"{dst}.weight")
        if f"{src}.bias" in flat:
            take(f"{src}.bias", f"{dst}.bias")

    def bn(src: str, dst: str) -> None:
        for k in _BN:
            take(f"{src}.{k}", f"{dst}.{k}")
        if f"{src}.num_batches_tracked" in flat:
            take(f"{src}.num_batches_tracked", f"{dst}.num_batches_tracked")

    # the ResNet, inlined under backbone. or nested
    res_pre = next((pre for pre in RESNET_PREFIXES
                    if f"{pre}conv1.weight" in flat
                    and f"{pre}layer1.0.conv1.weight" in flat), None)
    if res_pre is None:
        tops = sorted({k.split(".")[0] for k in flat})
        raise ValueError(
            f"unrecognized Pose2Seg checkpoint structure; keys: {tops[:20]}")
    body = re.compile(rf"{re.escape(res_pre)}(conv1\.|bn1\.|layer[1-4]\.)")
    for k in list(flat):
        if body.match(k):
            take(k, "backbone." + k[len(res_pre):])

    # the FPN convs, beside the ResNet
    fpn_pre = next((pre for pre in FPN_PREFIXES
                    if f"{pre}toplayer.weight" in flat), None)
    if fpn_pre is None:
        raise ValueError(
            "Pose2Seg checkpoint has no FPN convs (toplayer/latlayer/...) "
            f"under 'backbone.'; keys: {sorted(flat)[:20]}")
    missing = [n for n in FPN_CONVS if n not in OPTIONAL_FPN
               and f"{fpn_pre}{n}.weight" not in flat]
    if missing:
        raise ValueError(f"Pose2Seg FPN convs missing: {missing}")
    c = flat[f"{fpn_pre}toplayer.weight"].shape[0]
    for n in FPN_CONVS:
        if f"{fpn_pre}{n}.weight" in flat:
            conv(f"{fpn_pre}{n}", f"backbone.{n}")
        else:
            out[f"backbone.{n}.weight"] = torch.zeros(c, c, 3, 3)
        # a conv without its bias adds none, as the JAX model's does
        out.setdefault(f"backbone.{n}.bias", torch.zeros(c))

    # the SegModule (resnet10units)
    seg_keys = [k for k in flat if k.startswith("segnet.")]
    if not seg_keys:
        raise ValueError("Pose2Seg checkpoint has no segnet.* keys")
    stem = next((k for k in STEM_CONVS if k in flat), None)
    if stem is None:
        raise ValueError(f"segnet stem conv not found; keys: {seg_keys[:10]}")
    conv(stem.removesuffix(".weight"), "segnet.conv1")
    bn(stem.replace("conv1.weight", "bn1").replace("stem.0.weight", "stem.1")
       .replace("conv_in.weight", "bn_in"), "segnet.bn1")
    unit_pat = re.compile(r"^(segnet\..*?)\.(\d+)\.conv1\.weight$")
    containers = {}
    for k in seg_keys:
        m = unit_pat.match(k)
        if m:
            containers.setdefault(m.group(1), set()).add(int(m.group(2)))
    if not containers:
        raise ValueError(
            f"segnet residual units not found; keys: {seg_keys[:10]}")
    cont = max(containers, key=lambda name: len(containers[name]))
    units = sorted(containers[cont])
    for j, i in enumerate(units):
        for n in (1, 2, 3):
            conv(f"{cont}.{i}.conv{n}", f"segnet.layers.{j}.conv{n}")
            bn(f"{cont}.{i}.bn{n}", f"segnet.layers.{j}.bn{n}")
    cls = next((k for k in seg_keys if k.endswith(".weight")
                and k not in consumed and flat[k].ndim == 4
                and flat[k].shape[0] == 2), None)
    if cls is None:
        raise ValueError("segnet classifier (2-channel conv) not found")
    conv(cls.removesuffix(".weight"), "segnet.conv2")

    leftovers = [k for k in flat if k not in consumed
                 and not k.endswith("num_batches_tracked")
                 and k.split(".")[0] in ("backbone", "segnet")]
    if leftovers:
        raise ValueError(
            f"Pose2Seg checkpoint keys not mapped ({len(leftovers)}): "
            f"{leftovers[:12]}")

    seg_in = out["segnet.conv1.weight"].shape[1]
    cat_skeleton = seg_in > cfg.feature_channels
    if cat_skeleton and seg_in != cfg.feature_channels + cfg.skeleton_channels:
        raise ValueError(
            f"segnet expects {seg_in} input channels; model computes "
            f"{cfg.feature_channels} + {cfg.skeleton_channels} skeleton")
    cfg2 = replace(cfg, cat_skeleton=cat_skeleton, seg_units=len(units))
    with torch.device("meta"):
        want = P2S.Pose2Seg(cfg2).state_dict()
    for k in want:
        if k.endswith("num_batches_tracked"):
            out.setdefault(k, torch.tensor(0))
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"Pose2Seg checkpoint lacks {len(missing)} tensors "
                         f"of the model: {missing[:12]}")
    return out, cfg2
