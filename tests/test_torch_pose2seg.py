"""tpuseg_torch's Pose2Seg model and predictor against tpuseg's, on the CPU.

The same numpy-seeded weights go to both: a JAX param tree at narrow
widths (a ResNet-50 of stem width 16, ``feature_channels`` 128, 2 seg
units), turned into the port's state_dict by ``weights/from_jax.py``. At
the 128 canvas P2 is 32x32x128, which tpuseg's ``affine_align`` samples
with its window kernel (K4b) in interpret mode on the CPU, so the port's
gather-semantics sampler is held against the Pallas route here.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import template_people
from tpuseg.engine import pose2seg_engine as JE
from tpuseg.models import pose2seg as JP
from tpuseg.ops import sampling as JS
from tpuseg_torch.engine import pose2seg_engine as TE
from tpuseg_torch.models import pose2seg as TP
from tpuseg_torch.weights.from_jax import pose2seg_state_dict_from_jax

torch.set_num_threads(2)

WIDTH = 16  # the ResNet's stem width (tpuseg reads widths from the params)
CFG = dict(input_size=128, feature_channels=128, seg_units=2, align_size=32,
           max_people=3, paste_size=64)


def _conv(rng, kh, cin, cout, bias=True):
    return {"weight": (rng.standard_normal((kh, kh, cin, cout))
                       / np.sqrt(kh * kh * cin)).astype(np.float32),
            "bias": (rng.standard_normal(cout) * 0.1).astype(np.float32)
            if bias else None}


def _bn(rng, c):
    return {"weight": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "bias": (rng.standard_normal(c) * 0.1).astype(np.float32),
            "running_mean": (rng.standard_normal(c) * 0.1).astype(np.float32),
            "running_var": rng.uniform(0.5, 1.5, c).astype(np.float32)}


def _block(rng, cin, mid, cout, downsample):
    p = {"conv1": _conv(rng, 1, cin, mid, False), "bn1": _bn(rng, mid),
         "conv2": _conv(rng, 3, mid, mid, False), "bn2": _bn(rng, mid),
         "conv3": _conv(rng, 1, mid, cout, False), "bn3": _bn(rng, cout),
         "downsample": None, "conv2_offset": None}
    if downsample:
        p["downsample"] = {"conv": _conv(rng, 1, cin, cout, False),
                           "bn": _bn(rng, cout)}
    return p


def jax_tree(rng, cfg, width: int = WIDTH) -> dict:
    """tpuseg's Pose2Seg param tree (``init_params``' structure) at a
    ResNet stem width ``width``: numpy leaves from ``rng``, BatchNorm
    statistics and affines random."""
    bb = {"stem": {"conv": _conv(rng, 7, 3, width, False),
                   "bn": _bn(rng, width)}}
    cin = width
    for si, nblocks in enumerate((3, 4, 6, 3)):
        mid = width * 2 ** si
        bb[f"layer{si + 1}"] = [_block(rng, cin if bi == 0 else 4 * mid, mid,
                                       4 * mid, bi == 0)
                                for bi in range(nblocks)]
        cin = 4 * mid
    c = cfg.feature_channels
    c2 = 4 * width
    fpn = {"toplayer": _conv(rng, 1, 8 * c2, c),
           "latlayer1": _conv(rng, 1, 4 * c2, c),
           "latlayer2": _conv(rng, 1, 2 * c2, c),
           "latlayer3": _conv(rng, 1, c2, c)}
    for i in (1, 2, 3):
        fpn[f"smooth{i}"] = _conv(rng, 3, c, c)
    seg_in = c + (cfg.skeleton_channels if cfg.cat_skeleton else 0)
    seg = {"conv1": _conv(rng, 3, seg_in, c, False), "bn1": _bn(rng, c),
           "units": [_block(rng, c, c // 4, c, False)
                     for _ in range(cfg.seg_units)],
           "classifier": _conv(rng, 1, c, 2)}
    return {"backbone": bb, "fpn": fpn, "seg": seg}


@pytest.fixture(scope="module")
def narrow():
    """The port's ResNet at the tree's width, for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "ResNetFPN", functools.partial(TP.ResNetFPN,
                                                       width=WIDTH))
        yield


def port_model(tree, cfg, dtype=torch.float32):
    model = TP.build_model(cfg)
    model.load_state_dict(pose2seg_state_dict_from_jax(tree), strict=True)
    return model.to(dtype).eval()


def heads_inputs(rng, cfg, n):
    s = cfg.input_size
    x = TP.person_inputs(template_people(rng, n, s, s), cfg, 1.0)
    assert x["person_valid"][0, :n].all()
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_tpuseg(narrow, dtype):
    """The whole forward on one canvas, two people and an empty slot (the
    JAX model through its window kernel in interpret mode). f32: aligned
    logits within 2e-5 max|ref| (measured 2.1e-6: XLA's and PyTorch's
    convolutions and the window kernel's sums round differently), masks
    within 1e-5 (measured 2.7e-7). bf16: both models in bf16 (tpuseg's
    window kernel also builds its x weights in bf16, the port samples
    with f32 weights): logits within 5e-2 max|ref|, masks within 2e-2
    (measured 1.5e-2 and 8.3e-3)."""
    cfg = TP.Pose2SegConfig(**CFG)
    rng = np.random.default_rng(0)
    tree = jax_tree(rng, cfg)
    img = rng.standard_normal((1, 128, 128, 3)).astype(np.float32)
    x = heads_inputs(rng, cfg, 2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jdt), tree)
    jcfg = JP.Pose2SegConfig(**CFG)
    assert JS._affine_align_eligible(32, 32, 128, 32, jnp.dtype(jdt).itemsize)
    want = jax.jit(lambda p, *a: JP.forward(p, a[0].astype(jdt), *a[1:4],
                                            jcfg, skel_feats=a[4]))(
        jparams, img, x["theta"], x["inv_theta"], x["person_valid"],
        x["skel"])
    model = port_model(tree, cfg, tdt)
    with torch.no_grad():
        got = model(torch.from_numpy(img).permute(0, 3, 1, 2).to(tdt),
                    *(torch.from_numpy(x[k]) for k in
                      ("theta", "inv_theta", "person_valid", "skel")))
    lim = {"float32": (2e-5, 1e-5), "bfloat16": (5e-2, 2e-2)}[dtype]
    ref = np.asarray(want["aligned_logits"], np.float32)
    err = np.abs(got["aligned_logits"].float().numpy() - ref).max()
    assert err <= lim[0] * np.abs(ref).max(), err / np.abs(ref).max()
    m_ref = np.asarray(want["masks"], np.float32)
    assert got["masks"].shape == m_ref.shape
    err = np.abs(got["masks"].float().numpy() - m_ref).max()
    assert err <= lim[1], err
    assert not got["masks"][0, 2].any()  # the empty slot


def test_predictor_matches_tpuseg(narrow):
    """run_on_image end to end, f32, a 100x140 image with three people:
    the same valid flags; the binary masks may differ at boundary pixels
    (the port's uint8 resize meets cv2's to one level, its float resize
    rounds otherwise): at most 0.5 % of the pixels differ (measured
    0.0024 %)."""
    cfg = TP.Pose2SegConfig(**CFG)
    rng = np.random.default_rng(1)
    tree = jax_tree(rng, cfg)
    img = rng.integers(0, 256, (100, 140, 3)).astype(np.uint8)
    kp = template_people(rng, 3, 100, 140)
    want = JE.Pose2SegPredictor(JP.Pose2SegConfig(**CFG),
                                params=tree).run_on_image(img, kp)
    pred = TE.Pose2SegPredictor(cfg, state_dict=pose2seg_state_dict_from_jax(
        tree), device="cpu")
    got = pred.run_on_image(img, kp)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert got["masks"].shape == want["masks"].shape == (3, 100, 140)
    assert got["masks"].dtype == np.uint8
    assert got["masks"].any()
    assert (got["masks"] != want["masks"]).mean() <= 5e-3


def test_crowded_path_matches_monolithic(narrow):
    """Five people through max_people 2 (one backbone pass, heads in
    chunks of 2, 2, 1) and through max_people 8 (one forward): equal
    masks and valid flags."""
    rng = np.random.default_rng(2)
    cfg = TP.Pose2SegConfig(**{**CFG, "max_people": 8})
    sd = pose2seg_state_dict_from_jax(jax_tree(rng, cfg))
    img = rng.integers(0, 256, (96, 120, 3)).astype(np.uint8)
    kp = template_people(rng, 5, 96, 120)
    mono = TE.Pose2SegPredictor(cfg, state_dict=sd, device="cpu")
    crowd = TE.Pose2SegPredictor(TP.Pose2SegConfig(**{**CFG, "max_people": 2}),
                                 state_dict=sd, device="cpu")
    calls = []
    backbone = crowd.model.backbone.forward
    crowd.model.backbone.forward = lambda x: calls.append(1) or backbone(x)
    a, b = mono.run_on_image(img, kp), crowd.run_on_image(img, kp)
    assert len(calls) == 1
    np.testing.assert_array_equal(a["valid"], b["valid"])
    np.testing.assert_array_equal(a["masks"], b["masks"])
    assert a["valid"].all() and a["masks"].any()
