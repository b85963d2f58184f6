"""The YOLACT loss of tpuseg_torch (``models/yolact_loss.py``) against
tpuseg's ``models/yolact_loss.py``, term by term, on synthetic predictions
and padded targets with crowds, padding, duplicate gts (two gts with one
best prior) and tied OHEM scores. The mask-subset draws are the JAX
package's own: ``jax.random.split(key, B)``, then ``uniform(k, (N,))``.
f32, rtol 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuseg.models import yolact_loss as JL
from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.models import yolact_loss as YL

# pytest-xdist runs several workers on the CPU's cores: more torch threads
# each would only oversubscribe them
torch.set_num_threads(2)

B, G, K, C = 2, 8, 6, 5  # images, gt slots, prototypes, classes (incl bg)
CFG = dataclasses.replace(yolact_model_config("yolact_plus_resnet50"),
                          img_size=96, num_classes=C)
PRIORS = Y.make_priors_np(CFG)
N = PRIORS.shape[0]
S = 2 * Y.level_sizes(CFG)[0]  # prototype size
HS = Y.level_sizes(CFG)[0]
# masks_to_train below the positives' count, so that the draws choose
LCFG = dict(masks_to_train=8, use_maskiou=True)
KEY = jax.random.PRNGKey(3)


def jax_draws(key, b: int, n: int) -> np.ndarray:
    """The uniform draws tpuseg's total_loss makes for mask_loss."""
    return np.stack([np.asarray(jax.random.uniform(k, (n,)))
                     for k in jax.random.split(key, b)])


def _targets(rng) -> dict:
    xy = rng.uniform(0, 0.6, (B, G, 2))
    wh = rng.uniform(0.1, 0.4, (B, G, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[0, 1] = boxes[0, 0]  # a duplicate: two gts share a best prior
    classes = rng.integers(0, C - 1, (B, G)).astype(np.int64)
    classes[0, 6:] = -1  # padding
    classes[1, 5:] = -1
    crowd = np.zeros((B, G), bool)
    crowd[0, 5] = crowd[1, 4] = True  # a crowd in each image
    boxes[1, 4] = [0.0, 0.0, 0.9, 0.9]  # a large one: neutralises negatives
    masks = (rng.uniform(size=(B, G, S, S)) > 0.4).astype(np.float32)
    masks[:, :, : S // 3] = 0.0
    masks[0, 2, :, :] = 0.0  # a gt mask under discard_mask_area
    masks[0, 2, :3, :3] = 1.0
    return {"boxes": boxes, "classes": classes, "crowd": crowd,
            "masks_proto": masks,
            "masks_sem": (rng.uniform(size=(B, G, HS, HS)) > 0.5).astype(
                np.float32)}


def _preds(rng) -> dict:
    conf = rng.standard_normal((B, N, C)).astype(np.float32)
    conf[:, ::3] = np.round(conf[:, ::3])  # many tied mining scores
    conf[1, 100:140] = conf[1, 99]
    return {"loc": (rng.standard_normal((B, N, 4)) * 0.5).astype(np.float32),
            "conf": conf,
            "coeff": np.tanh(rng.standard_normal((B, N, K))).astype(
                np.float32),
            "proto": np.maximum(rng.standard_normal((B, S, S, K)), 0).astype(
                np.float32)}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    return _targets(rng), _preds(rng), rng.standard_normal(
        (B, HS, HS, C - 1)).astype(np.float32)


def _t(d: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in d.items()}


def _j(d: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in d.items()}


def _match_jax(tg):
    lcfg = JL.YolactLossConfig(**LCFG)
    out = [JL.match_priors(jnp.asarray(tg["boxes"][i]),
                           jnp.asarray(tg["classes"][i].astype(np.int32)),
                           jnp.asarray(tg["crowd"][i]), jnp.asarray(PRIORS),
                           lcfg) for i in range(B)]
    return [np.stack([np.asarray(o[j]) for o in out]) for j in range(3)]


def _match_port(tg):
    t = _t(tg)
    return YL.match_priors(t["boxes"], t["classes"], t["crowd"],
                           torch.from_numpy(PRIORS),
                           YL.YolactLossConfig(**LCFG))


def test_match_priors_matches_jax(data):
    tg, _, _ = data
    conf, idx, loc = _match_port(tg)
    wconf, widx, wloc = _match_jax(tg)
    np.testing.assert_array_equal(conf.numpy(), wconf)
    np.testing.assert_array_equal(idx.numpy(), widx)
    np.testing.assert_allclose(loc.numpy(), wloc, rtol=1e-5, atol=1e-5)
    # the duplicate gts claimed two priors; crowds neutralised negatives
    assert {0, 1} <= set(idx[0][conf[0] > 0].tolist())
    assert (conf == -1).sum() > (conf == 0).sum() // 20 > 0


def test_ohem_conf_loss_matches_jax(data):
    tg, preds, _ = data
    conf_t = _match_port(tg)[0]
    got = YL.ohem_conf_loss(torch.from_numpy(preds["conf"]), conf_t,
                            YL.YolactLossConfig(**LCFG))
    want = JL.ohem_conf_loss(jnp.asarray(preds["conf"]),
                             jnp.asarray(conf_t.numpy()),
                             JL.YolactLossConfig(**LCFG))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_mask_loss_and_maskiou_targets_match_jax(data):
    tg, preds, _ = data
    conf, idx, _ = _match_port(tg)
    draws = jax_draws(KEY, B, N)
    t, p = _t(tg), _t(preds)
    got_l, got_m = YL.mask_loss(p["proto"], p["coeff"], conf, idx,
                                t["boxes"], t["masks_proto"],
                                torch.from_numpy(draws),
                                YL.YolactLossConfig(**LCFG),
                                gt_classes=t["classes"])
    keys = jax.random.split(KEY, B)
    for i in range(B):
        want_l, want_m = JL.mask_loss(
            jnp.asarray(preds["proto"][i]), jnp.asarray(preds["coeff"][i]),
            jnp.asarray(conf[i].numpy()), jnp.asarray(idx[i].numpy()),
            jnp.asarray(tg["boxes"][i]), jnp.asarray(tg["masks_proto"][i]),
            keys[i], JL.YolactLossConfig(**LCFG),
            gt_classes=jnp.asarray(tg["classes"][i]))
        np.testing.assert_allclose(float(got_l[i]), float(want_l), rtol=1e-5)
        for k in ("label", "valid"):
            np.testing.assert_array_equal(got_m[k][i].numpy(),
                                          np.asarray(want_m[k]), err_msg=k)
        for k in ("input", "iou_t"):
            np.testing.assert_allclose(got_m[k][i].numpy(),
                                       np.asarray(want_m[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # the draws chose: more positives than masks_to_train, a small gt
    # mask discarded from the I term
    assert int((conf > 0).sum(1).min()) > LCFG["masks_to_train"]
    assert not bool(got_m["valid"].all())


def test_semantic_loss_matches_jax(data):
    tg, _, sem = data
    t = _t(tg)
    got = YL.semantic_loss(torch.from_numpy(sem), t["classes"],
                           t["masks_sem"], YL.YolactLossConfig(**LCFG),
                           gt_crowd=t["crowd"])
    for i in range(B):
        want = JL.semantic_loss(jnp.asarray(sem[i]),
                                jnp.asarray(tg["classes"][i]),
                                jnp.asarray(tg["masks_sem"][i]),
                                JL.YolactLossConfig(**LCFG),
                                gt_crowd=jnp.asarray(tg["crowd"][i]))
        np.testing.assert_allclose(float(got[i]), float(want), rtol=1e-5)


def test_total_loss_matches_jax(data):
    """Every term through each package's total_loss; the mask-IoU net a
    fixed linear map of the masks on both sides (FastMaskIoUNet itself is
    held against tpuseg in tests/test_torch_yolact.py)."""
    tg, preds, sem = data
    w = np.random.default_rng(1).standard_normal((S * S, C - 1)).astype(
        np.float32) / S
    tw = torch.from_numpy(w)
    got = YL.total_loss(_t(preds), torch.from_numpy(sem), _t(tg),
                        torch.from_numpy(PRIORS),
                        torch.from_numpy(jax_draws(KEY, B, N)),
                        YL.YolactLossConfig(**LCFG),
                        maskiou_net=lambda m: m.reshape(m.shape[0], -1) @ tw)
    want = jax.jit(lambda *a: JL.total_loss(
        *a, JL.YolactLossConfig(**LCFG),
        maskiou_fn=lambda m: m.reshape(m.shape[0], -1) @ jnp.asarray(w)))(
        _j(preds), jnp.asarray(sem), _j(tg), jnp.asarray(PRIORS), KEY)
    assert list(got) == ["B", "C", "M", "S", "I", "total"]
    assert set(want) == set(got)
    for k, v in got.items():
        assert np.isfinite(float(v)) and float(v) > 0, k
        np.testing.assert_allclose(float(v), float(want[k]), rtol=1e-5,
                                   err_msg=k)
