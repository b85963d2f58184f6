"""ViTDet Mask R-CNN (``models/vitdet.py``, ``nn/vitdet.py``) against the
plain reference the benchmark holds it to (``benchmark/reference/frozen/
vitdet.py`` and ``maskrcnn_infer.py``), on seeded random weights at a small
size: embed 96, 2 heads, 6 blocks with global attention at 2 and 5, a
window of 3 over an 8 x 8 token grid (so the grid is padded to 9 x 9), the
relative-position tables and LayerNorm affines non-zero. The backbone and
pyramid outputs within float32 tolerance, the predictor's detections
detection for detection; the window partition and the relative-position
gather; and the comparison's sensitivity to a global block made windowed,
a zeroed table and masked padded keys."""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.common import weights as W
from benchmark.configs import maskrcnn_vitdet_b as BC
from benchmark.reference.frozen import maskrcnn as RM
from benchmark.reference.frozen import maskrcnn_infer as RI
from benchmark.reference.frozen import vitdet as RV
from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor, variant_of
from tpuseg_torch.models import vitdet as VD
from tpuseg_torch.nn import vitdet as N

torch.set_num_threads(2)

CFG = VD.ViTDetConfig(
    img_size=128, embed_dim=96, vit_depth=6, num_heads=2, window_size=3,
    window_block_indexes=(0, 1, 3, 4), pretrain_img_size=96,
    fpn_channels=32, num_classes=5, box_fc_dim=64, min_size_test=128,
    max_size_test=128)
RCNN_FIELDS = [f.name for f in dataclasses.fields(RM.MaskRCNNConfig)]
VIT_FIELDS = ("img_size", "patch_size", "embed_dim", "num_heads",
              "mlp_ratio", "window_size", "window_block_indexes",
              "pretrain_img_size", "ln_eps", "scale_factors", "box_fc_dim")
RTOL = 1e-4  # of the largest magnitude of each output, float32 both sides


def reference(cfg=CFG) -> RV.ViTDetMaskRCNN:
    rcnn = RM.MaskRCNNConfig(**{k: getattr(cfg, k) for k in RCNN_FIELDS})
    return RV.build_model(rcnn, dict(
        {k: getattr(cfg, k) for k in VIT_FIELDS}, depth=cfg.vit_depth))


def state(seed: int = 7, cfg=CFG) -> dict:
    """The benchmark's weight scheme at this size."""
    with torch.device("meta"):
        shell = VD.ViTDetMaskRCNN(cfg)
    return W.synthetic_state_dict(shell, seed, torch.device("cpu"),
                                  BC.weight_rule)


def images(seed: int = 3, n: int = 2) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 3, CFG.img_size, CFG.img_size), generator=g)


def port(sd: dict, cfg=CFG) -> VD.ViTDetMaskRCNN:
    model = VD.build_model(cfg)
    model.load_state_dict(sd, strict=True)
    return model


def close(a: list, b: list) -> bool:
    return all(torch.allclose(x, y, rtol=0, atol=RTOL * float(y.abs().max()))
               for x, y in zip(a, b))


@pytest.fixture(scope="module")
def outputs():
    sd = state()
    ref = reference()
    ref.load_state_dict(sd, strict=True)
    x = images()
    with torch.no_grad():
        return sd, x, ref.backbone(x), ref.backbone.net(x)


def test_backbone_and_pyramid_match_the_reference(outputs):
    sd, x, ref_pyr, ref_vit = outputs
    model = port(sd)
    assert variant_of(model.cfg) == "vitdet"
    assert len(model.backbone.net.blocks[0].attn.rel_pos_h) == 5
    assert len(model.backbone.net.blocks[2].attn.rel_pos_h) == 15
    with torch.no_grad():
        vit = model.backbone.net(x)
        pyr = model.backbone(x)
    assert vit.shape == (2, 96, 8, 8)
    assert [tuple(p.shape[-2:]) for p in pyr] == [(32, 32), (16, 16),
                                                   (8, 8), (4, 4), (2, 2)]
    assert close([vit], [ref_vit])
    assert close(pyr, ref_pyr)


def masked_padding_attention(monkeypatch):
    """The padded keys masked out of the windowed blocks' softmax."""
    part = N.window_partition
    seen = {}

    def spy(x, window):
        out, pad_hw = part(x, window)
        valid = x.new_zeros(x.shape[:3] + (1,))
        valid = torch.nn.functional.pad(valid + 1, (0, 0, 0, pad_hw[1]
                                                    - x.shape[2], 0,
                                                    pad_hw[0] - x.shape[1]))
        seen["keys"] = valid.view(x.shape[0], pad_hw[0] // window, window,
                                  pad_hw[1] // window, window).permute(
            0, 1, 3, 2, 4).reshape(-1, window * window) > 0
        return out, pad_hw

    def masked(q, k, v, table_h, table_w, hw, scale):
        h, w = hw
        n, t, c = q.shape
        r_q = q.view(n, h, w, c)
        attn = (q * scale) @ k.transpose(-2, -1)
        attn = (attn.view(n, h, w, h, w)
                + torch.einsum("nhwc,hkc->nhwk", r_q,
                               N.gathered_rel_pos(table_h, h))[..., None]
                + torch.einsum("nhwc,wkc->nhwk", r_q,
                               N.gathered_rel_pos(table_w, w))[:, :, :, None]
                ).view(n, t, t)
        if t == seen["keys"].shape[1]:
            keys = seen["keys"].repeat_interleave(n // len(seen["keys"]), 0)
            attn = attn.masked_fill(~keys[:, None, :], float("-inf"))
        return torch.softmax(attn, -1) @ v

    monkeypatch.setattr(N, "window_partition", spy)
    monkeypatch.setattr(N, "rel_pos_attention", masked)


def global_block_windowed(model):
    """Block 2 attends in windows, its tables cut to the window's rows."""
    blk = model.backbone.net.blocks[2]
    ws = CFG.window_size
    blk.window_size = ws
    g = CFG.img_size // CFG.patch_size
    for name in ("rel_pos_h", "rel_pos_w"):
        t = getattr(blk.attn, name)
        setattr(blk.attn, name, torch.nn.Parameter(
            t.data[g - ws:g + ws - 1].clone()))


def zeroed_table(model):
    model.backbone.net.blocks[0].attn.rel_pos_w.data.zero_()


@pytest.mark.parametrize("fault", ["global_block_windowed", "zeroed_table",
                                   "masked_padding_attention"])
def test_the_comparison_sees_each_fault(outputs, monkeypatch, fault):
    sd, x, ref_pyr, ref_vit = outputs
    model = port(sd)
    if fault == "masked_padding_attention":
        masked_padding_attention(monkeypatch)
    else:
        globals()[fault](model)
    with torch.no_grad():
        assert not close([model.backbone.net(x)], [ref_vit])
        assert not close(model.backbone(x), ref_pyr)


@pytest.mark.parametrize("hw,window", [((8, 8), 3), ((6, 9), 4), ((7, 7), 7),
                                       ((14, 5), 14)])
def test_partition_then_unpartition_is_the_identity(hw, window):
    x = torch.randn((2,) + hw + (5,))
    parts, pad_hw = N.window_partition(x, window)
    assert pad_hw == tuple(-(-s // window) * window for s in hw)
    assert parts.shape == (2 * pad_hw[0] * pad_hw[1] // window ** 2, window,
                           window, 5)
    # windows run row by row over each image's padded grid
    padded = torch.nn.functional.pad(x, (0, 0, 0, pad_hw[1] - hw[1], 0,
                                         pad_hw[0] - hw[0]))
    per_image = pad_hw[0] * pad_hw[1] // window ** 2
    assert torch.equal(parts[0], padded[0, :window, :window])
    assert torch.equal(parts[per_image - 1], padded[0, -window:, -window:])
    assert torch.equal(parts[per_image], padded[1, :window, :window])
    assert torch.equal(N.window_unpartition(parts, window, pad_hw, hw), x)
    ref, ref_pad = RV.window_partition(x, window)
    assert torch.equal(parts, ref) and ref_pad == pad_hw


@pytest.mark.parametrize("size", [3, 14, 64])
def test_gathered_tables_are_the_index_formula(size):
    table = torch.randn(2 * size - 1, 4)
    got = N.gathered_rel_pos(table, size)
    for i in range(size):
        for j in range(size):
            assert torch.equal(got[i, j], table[(i - j) + (size - 1)])
    assert torch.equal(got, RV.get_rel_pos(size, size, table))
    with pytest.raises(ValueError, match="canvas"):
        N.gathered_rel_pos(table[:-1], size)


def test_predictor_detections_match_the_reference(outputs):
    sd = dict(outputs[0])
    ref = reference()
    ref.load_state_dict(sd, strict=True)
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
              for _ in range(2)]
    norm = (CFG.pixel_mean, CFG.pixel_std)
    with torch.no_grad():
        logits = [RI.class_logits(ref, torch.from_numpy(x), hw) for x, hw in
                  (RI.canvas(f, 128, 128, norm) for f in frames)]
    scale, bias = RI.class_calibration(
        logits, sd["roi_heads.box.predictor.cls_score.bias"], CFG.score_thresh)
    sd["roi_heads.box.predictor.cls_score.weight"] *= scale
    sd["roi_heads.box.predictor.cls_score.bias"] = bias
    ref.load_state_dict(sd, strict=True)
    pred = MaskRCNNPredictor(model=port(sd), device="cpu")
    assert (pred.min_image_size, pred.max_image_size) == (128, 128)
    with torch.no_grad():
        want = list(RI.requests(ref, frames, 128, 128, "cpu", norm))
    for img, r in zip(frames, want):
        got = pred.run_on_bgr_image(img[:, :, ::-1])
        assert 10 <= len(r["scores"]) <= 100
        po = np.argsort(-got["scores"], kind="stable")
        ro = np.argsort(-r["scores"], kind="stable")
        assert np.array_equal(got["classes"][po], r["classes"][ro])
        np.testing.assert_allclose(got["scores"][po], r["scores"][ro],
                                   rtol=1e-4)
        np.testing.assert_allclose(got["boxes"][po], r["boxes"][ro],
                                   atol=1e-2)
        differ = np.count_nonzero(got["masks"][po] != r["masks"][ro])
        assert differ <= 1e-4 * got["masks"].size, differ
