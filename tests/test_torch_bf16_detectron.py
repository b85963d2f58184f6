"""bf16 inference of the detectron family in tpuseg_torch against tpuseg's
``MaskRCNNPredictor(dtype=bfloat16)``: Mask R-CNN R-50-FPN, R-50-C4 and
RetinaNet R-50-FPN at a ResNet stem width of 16 (the port's ResNet
narrowed, the JAX package reads its widths from the weights), 9 classes,
the upstream-keyed synthetic weights of chip_smoke cast to bf16 by each
predictor. Held: the raw head outputs (RPN or RetinaNet logits and deltas
on every level; for the FPN model also the box head and the mask head on
the same rois through the multi-level RoIAlign in bf16), and the
predictor's detections come back in f32.

Both packages compute each layer in bf16 with f32 accumulation and round
its output to bf16, but their convolutions sum in different orders, so a
value sits a bf16 step (2^-8 relative) apart here and there, and the steps
add up through the layers. Measured on the CPU (torch 2.13.0+cpu), port
against tpuseg: the largest error of an output 3.1e-2 of max|ref| (FPN),
1.9e-2 (C4), 2.5e-2 (RetinaNet), the mean error at most 7.4e-3; held at
6e-2 and 1.5e-2. Both
are bf16 rounding: each package's bf16 outputs lie as far from the port's
f32 outputs as the other's (mean distance, port over tpuseg, 0.89-1.10),
held at 1.5.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_state_dict
from tests.test_cross_parity import NC
from tpuseg.engine import maskrcnn_engine as JE
from tpuseg.models import maskrcnn as JM
from tpuseg.models import maskrcnn_c4 as JC4
from tpuseg.models import retinanet as JRN
from tpuseg.weights.detectron_map import from_torch_state as fpn_from_torch
from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_c4 as C4
from tpuseg_torch.models import retinanet as RN
from tpuseg_torch.nn.resnet import ResNet

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

CANVAS = (128, 192)
IMAGE_HW = np.array([CANVAS, (100, 150)], np.int64)
WIDTH = 16
MAX_ERR = 6e-2  # of max|ref|, any element
MEAN_ERR = 1.5e-2  # of max|ref|, the mean
F32_RATIO = 1.5

VARIANTS = {
    "fpn": (M, M.MaskRCNNConfig(num_classes=NC), JM.MaskRCNNConfig(
        num_classes=NC), fpn_from_torch),
    "c4": (C4, C4.MaskRCNNC4Config(num_classes=NC), JC4.MaskRCNNC4Config(
        num_classes=NC), JC4.from_torch_state),
    "retinanet": (RN, RN.RetinaNetConfig(num_classes=NC),
                  JRN.RetinaNetConfig(num_classes=NC), JRN.from_torch_state),
}


def _port_heads(variant: str, model, x: torch.Tensor, boxes) -> list:
    if variant == "c4":
        logits, deltas = model.rpn.head([model.backbone(x)])
        return [*logits, *deltas]
    pyramid = model.backbone(x)
    logits, deltas = model.rpn.head(pyramid)
    out = [*logits, *deltas]
    if variant == "fpn":
        feats = [f.contiguous(memory_format=torch.channels_last)
                 for f in pyramid[:4]]
        bidx = torch.arange(2).repeat_interleave(boxes.shape[0] // 2)
        out += model.roi_heads.box(M.pooled_roi_features(feats, boxes, bidx,
                                                         7, 2))
        out.append(model.roi_heads.mask(
            M.pooled_roi_features(feats, boxes, bidx, 14, 2),
            torch.arange(boxes.shape[0]) % (NC - 1) + 1))
    return out


def _jax_heads(variant: str, p, x, jcfg, boxes) -> list:
    if variant == "c4":
        logits, deltas = JM.rpn_head(p["rpn"], [JC4.backbone_c4(p, x, jcfg)])
        return [*logits, *deltas]
    if variant == "retinanet":
        logits, deltas = JRN.head_forward(p, JRN.backbone_p3p7(p, x, jcfg),
                                          jcfg)
        return [*logits, *deltas]
    pyramid = JM.backbone_fpn(p, x, jcfg)
    logits, deltas = JM.rpn_head(p["rpn"], pyramid)
    bidx = jnp.repeat(jnp.arange(2), boxes.shape[0] // 2)
    pooled = JM.pooled_roi_features(pyramid[:4], boxes, bidx, 7, 2)
    mask = JM.mask_head(p["mask_head"], JM.pooled_roi_features(
        pyramid[:4], boxes, bidx, 14, 2),
        class_sel=jnp.arange(boxes.shape[0]) % (NC - 1) + 1)
    return [*logits, *deltas, *JM.box_head(p["box_head"], pooled), mask]


@pytest.fixture(scope="module", params=list(VARIANTS))
def heads(request):
    variant = request.param
    mod, cfg, jcfg, jax_reader = VARIANTS[variant]
    rng = np.random.default_rng(21)
    images = np.zeros((2, 3, *CANVAS), np.float32)
    for i, (h, w) in enumerate(IMAGE_HW):
        images[i, :, :h, :w] = rng.standard_normal((3, h, w)) * 40.0
    xy = rng.uniform(0, 100, (64, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 90, (64, 2))],
                           1).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mod, "ResNet", functools.partial(ResNet, width=WIDTH))
        model = mod.build_model(cfg)
        sd = synthetic_state_dict(model, 23)
        model.load_state_dict(sd, strict=True)
        x = torch.from_numpy(images)
        with torch.inference_mode():
            ref = _port_heads(variant, model, x, torch.from_numpy(boxes))
        pred = MaskRCNNPredictor(model=model, device="cpu",
                                 dtype=torch.bfloat16)
        with torch.inference_mode():
            got = _port_heads(variant, pred.model, x.bfloat16(),
                              torch.from_numpy(boxes))
            out = pred.forward(x, torch.from_numpy(IMAGE_HW))
    jpred = JE.MaskRCNNPredictor(
        cfg=jcfg, params=jax_reader({k: v.numpy() for k, v in sd.items()},
                                    jcfg),
        dtype=jnp.bfloat16, variant=variant)
    want = jax.jit(functools.partial(_jax_heads, variant, jcfg=jcfg))(
        jpred.params, jnp.asarray(images.transpose(0, 2, 3, 1), jnp.bfloat16),
        boxes=jnp.asarray(boxes))
    return variant, got, want, out, ref


def test_bf16_heads_match_jax_bf16(heads):
    """Each head output against tpuseg's bf16 one: any element within
    MAX_ERR of max|ref|, the mean within MEAN_ERR; and its mean distance
    from the port's f32 output no more than F32_RATIO times tpuseg's."""
    variant, got, want, _, ref = heads
    assert len(got) == len(want) == len(ref)
    for i, (g, w, r) in enumerate(zip(got, want, ref)):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16, i
        g = g.float().numpy().reshape(-1)
        w = np.asarray(w, np.float32).reshape(-1)
        r = r.numpy().reshape(-1)
        assert g.shape == w.shape == r.shape, i
        scale = np.abs(w).max()
        err = np.abs(g - w)
        assert err.max() <= MAX_ERR * scale, (variant, i, err.max() / scale)
        assert err.mean() <= MEAN_ERR * scale, (variant, i,
                                                err.mean() / scale)
        port_f32, jax_f32 = np.abs(g - r).mean(), np.abs(w - r).mean()
        assert port_f32 <= F32_RATIO * jax_f32, (variant, i, port_f32,
                                                 jax_f32)


def test_bf16_predictor_outputs_are_f32(heads):
    _, _, _, out, _ = heads
    for k, v in out.items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, k
            assert torch.isfinite(v).all(), k
    assert out["valid"].any()
