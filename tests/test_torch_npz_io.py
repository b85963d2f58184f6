"""The JAX package's npz params in tpuseg_torch, on the CPU: npz files that
tpuseg's ``save_params_npz`` writes (YOLOv3, ViT, Pose2Seg) load into the
port (the state_dicts equal ``weights/from_jax.py``'s, the outputs equal
tpuseg's), and the port's writer's files are read by tpuseg's
``load_params_npz`` with equal arrays."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_pose2seg import WIDTH, jax_tree
from tpuseg.engine.trainer import load_params_npz as j_load_npz
from tpuseg.engine.trainer import save_params_npz as j_save_npz
from tpuseg.models import yolov3 as JY
from tpuseg.nn import vit as JV
from tpuseg_torch.engine.classify import build_vit
from tpuseg_torch.engine.yolo_engine import YoloPredictor
from tpuseg_torch.models import pose2seg as TP
from tpuseg_torch.models import yolov3 as TY
from tpuseg_torch.nn import vit as TV
from tpuseg_torch.weights import npz_io
from tpuseg_torch.weights.from_jax import (pose2seg_state_dict_from_jax,
                                           vit_jax_from_state_dict,
                                           vit_state_dict_from_jax,
                                           yolov3_jax_from_state_dict,
                                           yolov3_state_dict_from_jax)
from tpuseg_torch.weights.pose2seg_map import load_pose2seg_weights

torch.set_num_threads(2)

VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
           num_heads=4, mlp_dim=128, num_classes=7)


def random_like(init, seed: int):
    """A tree of ``init``'s structure (traced, not run) with numpy leaves:
    N(0, 0.05^2), BatchNorm variances U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init)

    def leaf(path, s):
        if "running_var" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 1.5, s.shape).astype(s.dtype)
        return (rng.standard_normal(s.shape) * 0.05).astype(s.dtype)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def assert_trees_equal(got, want) -> int:
    """Equal structure (``None`` leaves of ``want`` absent or ``None`` in
    ``got``) and leaves equal bit for bit -> the arrays compared."""
    g = npz_io.flatten_params(got)
    w = npz_io.flatten_params(want)
    assert g.keys() == w.keys()
    for k, v in w.items():
        np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(v),
                                      err_msg=k)
    return len(w)


def test_flatten_and_unflatten_are_inverse():
    tree = {"a": [{"w": np.ones(2)}, None, {"w": np.zeros(3), "b": None}],
            "c": {"d": np.arange(4), "e": [np.ones(1), np.ones(1)]}}
    flat = npz_io.flatten_params(tree)
    assert sorted(flat) == ["a.0.w", "a.2.w", "c.d", "c.e.0", "c.e.1"]
    back = npz_io.unflatten_params(flat)
    assert back["a"][1] is None and "b" not in back["a"][2]
    assert_trees_equal(back, tree)


def test_yolov3_npz_from_tpuseg_loads_into_the_port(tmp_path):
    """tpuseg's npz of a YOLOv3 tree: the port's state_dict is
    ``yolov3_state_dict_from_jax`` of the tree, bit for bit, and
    YoloPredictor's head maps meet tpuseg's within 1e-4 max|ref|."""
    cfg = TY.YoloV3Config(input_size=64)
    jcfg = JY.YoloV3Config(input_size=64)
    tree = random_like(lambda: JY.init_params(jax.random.PRNGKey(0), jcfg),
                       1)
    path = str(tmp_path / "yolov3.npz")
    j_save_npz(path, tree)
    pred = YoloPredictor(cfg, weights=path, device="cpu")
    want_sd = yolov3_state_dict_from_jax(tree)
    got_sd = pred.model.state_dict()
    assert got_sd.keys() == want_sd.keys()
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    want = jax.jit(lambda p, x: JY.forward(p, x, jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    with torch.no_grad():
        got = pred.model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


def test_vit_npz_from_tpuseg_loads_into_the_port(tmp_path):
    """tpuseg's npz of a ViT tree (its blocks stacked on a layer axis):
    the port's logits meet tpuseg's within 1e-5 of max|ref|."""
    cfg, jcfg = TV.ViTConfig(**VIT), JV.ViTConfig(**VIT)
    tree = random_like(lambda: JV.init_params(jax.random.PRNGKey(0), jcfg),
                       3)
    path = str(tmp_path / "vit.npz")
    j_save_npz(path, tree)
    model = build_vit(cfg, vit_state_dict_from_jax(npz_io.load_params_npz(
        path)))
    x = np.random.default_rng(4).standard_normal((2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda p, x: JV.forward(p, x, jcfg))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("family", ["yolov3", "vit"])
def test_port_writer_is_read_by_tpuseg(tmp_path, family):
    """The port's model -> its JAX tree -> the port's ``save_params_npz``
    -> tpuseg's ``load_params_npz`` on its own template tree: every array
    equal, and back to the same state_dict."""
    if family == "yolov3":
        model = TY.build_model(TY.YoloV3Config(input_size=64),
                               torch.Generator().manual_seed(6))
        to_jax, from_jax = yolov3_jax_from_state_dict, \
            yolov3_state_dict_from_jax
        like = jax.eval_shape(lambda: JY.init_params(jax.random.PRNGKey(0),
                                                     JY.YoloV3Config()))
    else:
        model = TV.build_model(TV.ViTConfig(**VIT),
                               torch.Generator().manual_seed(6))
        to_jax, from_jax = vit_jax_from_state_dict, vit_state_dict_from_jax
        like = jax.eval_shape(lambda: JV.init_params(jax.random.PRNGKey(0),
                                                     JV.ViTConfig(**VIT)))
    sd = model.state_dict()
    tree = to_jax(sd)
    path = str(tmp_path / f"{family}.npz")
    npz_io.save_params_npz(path, tree)
    back = j_load_npz(path, like)
    n = assert_trees_equal(back, tree)
    assert n == sum(x is not None for x in jax.tree.leaves(like))
    for k, v in jax.tree.leaves_with_path(back):
        assert v.dtype == jnp.float32, k
    again = from_jax(jax.tree.map(np.asarray, back))
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again[k], v), k


def test_pose2seg_npz_from_tpuseg_loads(tmp_path):
    """tpuseg's npz of a Pose2Seg tree (ResNet stem width 16): the port's
    ``load_pose2seg_weights`` gives ``pose2seg_state_dict_from_jax`` of it,
    bit for bit, the config unchanged, and the model loads it strictly."""
    cfg = TP.Pose2SegConfig(seg_units=2)
    tree = jax_tree(np.random.default_rng(8), cfg)
    path = str(tmp_path / "pose2seg.npz")
    j_save_npz(path, tree)
    sd, cfg2 = load_pose2seg_weights(path, cfg)
    assert cfg2 == cfg
    want = pose2seg_state_dict_from_jax(tree)
    assert sd.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "ResNetFPN", functools.partial(TP.ResNetFPN,
                                                       width=WIDTH))
        TP.build_model(cfg).load_state_dict(sd, strict=True)
