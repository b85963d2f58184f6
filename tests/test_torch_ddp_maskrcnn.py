"""The port's data-parallel Mask R-CNN step on 2 gloo ranks of the CPU in
f64 (``test_parallel.py::test_maskrcnn_train_step_identity_1v8``'s 32 x 32
config, weights from tpuseg's ``init_params``, tpuseg's own draws, B = 4
as 2 x 2): against the port's one process at rtol 1e-5 / atol 1e-7
max|g|, its losses against tpuseg's single-device step. And the
collectives' helpers of ``parallel/ddp.py`` on 2 ranks, and a bf16 step
(``call_bound`` on ``cast_floats``) whose gradients reach DDP's hooks on
the f32 masters. YOLACT's step: ``tests/test_torch_ddp.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests import torch_ranks
from tests.test_torch_ddp import assert_tree_close
from tests.test_torch_maskrcnn_loss import jax_draws_per_image
from tpuseg.models import maskrcnn as JM
from tpuseg.models import maskrcnn_loss as JML
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_loss as ML
from tpuseg_torch.weights.from_jax import state_dict_from_jax

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

MRCNN_KW = dict(rpn_pre_nms_top_n=16, rpn_post_nms_top_n=16,
                fpn_post_nms_top_n=8, detections_per_img=4,
                pre_final_nms_topk=32, num_classes=5)


def _tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def maskrcnn(tmp_path_factory):
    rng = np.random.default_rng(0)
    jcfg = JM.MaskRCNNConfig(**MRCNN_KW)
    cfg = M.MaskRCNNConfig(**MRCNN_KW)
    lkw = dict(num_classes=5, rpn_batch_per_image=8, roi_batch_per_image=8)
    params32 = jax.jit(lambda k: JM.init_params(k, jcfg))(
        jax.random.PRNGKey(2))
    b, gm = 4, 4
    xy = rng.uniform(0, 14, (b, gm, 2))
    wh = rng.uniform(6, 16, (b, gm, 2))
    classes = rng.integers(0, 4, (b, gm)).astype(np.int32)
    classes[:, gm // 2:] = -1
    targets = {"boxes": np.concatenate([xy, xy + wh], -1),
               "classes": classes,
               "mask_crops": (rng.uniform(size=(b, gm, 32, 32)) > 0.5)
               .astype(np.float64)}
    images = rng.standard_normal((b, 32, 32, 3))
    hw = np.asarray([[32, 32]] * b, np.int32)
    key = jax.random.PRNGKey(3)
    n_anchors = sum(a.shape[0] for a in M.make_anchors_np(cfg, 32, 32))
    with jax.enable_x64(True):
        k_rpn, k_roi = jax.random.split(key)
        draws = {"rpn": jax_draws_per_image(k_rpn, b, n_anchors),
                 "roi": jax_draws_per_image(
                     k_roi, b, cfg.fpn_post_nms_top_n_train + gm)}
    inp = {"cfg": cfg, "loss_cfg": ML.MaskRCNNLossConfig(**lkw),
           "state": state_dict_from_jax(_tree(params32), cfg),
           "images": torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
           "image_hw": torch.from_numpy(hw).long(),
           "targets": {k: torch.from_numpy(v) for k, v in targets.items()},
           "draws": draws}
    inp["targets"]["classes"] = inp["targets"]["classes"].long()
    ranks = torch_ranks.start("maskrcnn_step", 2,
                              tmp_path_factory.mktemp("mrcnn"), inp)
    with jax.enable_x64(True):
        params = jax.tree.map(
            lambda v: v.astype(jnp.float64)
            if jnp.issubdtype(v.dtype, jnp.floating) else v, params32)
        losses = jax.jit(lambda p: JM.forward_train_losses(
            p, jnp.asarray(images), jnp.asarray(hw),
            jax.tree.map(jnp.asarray, targets), key, jcfg,
            JML.MaskRCNNLossConfig(**lkw)))(params)
    return {"jax": {k: float(v) for k, v in losses.items()},
            "one": torch_ranks.maskrcnn_step(inp),
            "ranks": ranks.wait(timeout=240)}


def test_maskrcnn_two_ranks_match_one_process(maskrcnn):
    """rtol 1e-5 / atol 1e-7 max|g| (``test_parallel.py``'s sharded
    step); the losses, taken at the loss boundary in f32, at rtol 1e-6."""
    one = maskrcnn["one"]
    assert one["losses"]["total"] > 0
    for r in maskrcnn["ranks"]:
        for k, v in one["losses"].items():
            np.testing.assert_allclose(r["losses"][k], v, rtol=1e-6,
                                       err_msg=k)
        assert_tree_close(r["grads"], one["grads"], 1e-5, 1e-7, "grads")


def test_maskrcnn_losses_match_tpuseg(maskrcnn):
    """The two ranks' global losses against tpuseg's single-device step on
    its own draws: rtol 1e-4 (``tests/test_torch_maskrcnn_train.py``'s
    f32 losses; the loss boundary is f32 on both sides)."""
    got, want = maskrcnn["ranks"][0]["losses"], maskrcnn["jax"]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-7,
                                   err_msg=k)


def test_collectives_on_two_ranks(tmp_path):
    g = torch.Generator().manual_seed(1)
    values = [torch.rand(9, generator=g), torch.rand(6, generator=g)]
    values[1][2] = float("-inf")
    outs = torch_ranks.spawn("collectives", 2, tmp_path,
                             {"values": values, "k": 5}, timeout=60)
    both = torch.cat(values)
    rows = torch.rand((4, 3), generator=torch.Generator().manual_seed(5))
    for r, o in enumerate(outs):
        assert o["kth"] == torch.topk(both, 5).values[-1]
        assert o["kth_big"] == torch.topk(both, 15).values[-1]
        assert torch.equal(o["rows"], rows[2 * r:2 * r + 2])
        assert float(o["denominator"]) == 1.5  # (0 + 3) / 2
        assert float(o["mean"]["a"]) == 1.5 and float(o["mean"]["b"]) == 1.0


def test_bf16_step_reaches_ddp_hooks_on_the_f32_masters(tmp_path):
    """Two bf16 steps of a conv-BatchNorm-conv net through ``call_bound``
    over DDP on 2 ranks: the masters and their gradients f32, every
    gradient the same on both ranks (reduced by DDP's hooks) and within
    2e-2 relative L2 of one process's bf16 step on the whole batch (a
    gradient that BatchNorm cancels, zero to 1e-2 of the largest)."""
    torch.manual_seed(0)
    net = torch_ranks.TinyNet()
    g = torch.Generator().manual_seed(2)
    inp = {"state": net.state_dict(),
           "x": [torch.randn((8, 3, 8, 8), generator=g) for _ in range(2)],
           "t": [torch.randn((8, 4, 8, 8), generator=g) for _ in range(2)]}
    outs = torch_ranks.spawn("bf16_ddp", 2, tmp_path, inp, timeout=60)
    one = torch_ranks.bf16_ddp_job(inp)
    for o in outs:
        assert all(d == (torch.float32, torch.float32)
                   for d in o["dtypes"].values())
    for step in range(2):
        scale = max(float(w.abs().max()) for w in one["grads"][step].values())
        for k, want in one["grads"][step].items():
            a, b = outs[0]["grads"][step][k], outs[1]["grads"][step][k]
            assert torch.equal(a, b), (step, k)
            if float(want.abs().max()) <= 1e-2 * scale:
                # conv1's bias, cancelled by BatchNorm's batch mean: zero
                # but for bf16 residue on both sides
                assert float(a.abs().max()) <= 1e-2 * scale, (step, k)
                continue
            err = float((a - want).norm() / want.norm())
            assert err <= 2e-2, (step, k, err)
