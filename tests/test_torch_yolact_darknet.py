"""YOLACT-550 DarkNet53-FPN in tpuseg_torch against tpuseg: the whole
forward and detect at full width (DarkNet-53's C3-C5, 256 FPN channels, 81
classes, 32 prototypes) on a 128x128 canvas, B = 2, with upstream-keyed
weights from a numpy seed read by tpuseg's ``from_torch_state`` and carried
to the port by ``yolact_state_dict_from_jax``; upstream's DarkNet keys both
ways (tpuseg's ``to_torch_state`` into the port, the port's checkpoint into
tpuseg's ``load_params_ckpt``); the npz tree both ways; ``freeze_bn`` on
DarkNet's BatchNorms. The tolerances are ``tests/test_torch_yolact.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import calibrate_yolact_gate, synthetic_yolact_state_dict
from tests.test_torch_yolact import _assert_same_detections, _jcfg
from tpuseg.engine import trainer as JT
from tpuseg.models import yolact as JY
from tpuseg.ops.preprocess import yolact_preprocess as j_preprocess
from tpuseg.weights.yolact_map import from_torch_state, to_torch_state
from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.engine import trainer as TT
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.nn.darknet import BatchNorm2d as DarkNetBN
from tpuseg_torch.ops.preprocess import yolact_preprocess
from tpuseg_torch.weights.from_jax import (yolact_jax_from_state_dict,
                                           yolact_state_dict_from_jax)
from tpuseg_torch.weights.npz_io import load_params_npz, save_params_npz
from tpuseg_torch.weights.yolact_map import (load_yolact_weights,
                                             upstream_state_dict)

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

CANVAS = 128
IMAGES_HW = (150, 130)


def _np(tree):
    return jax.tree.map(lambda a: None if a is None else np.asarray(a), tree,
                        is_leaf=lambda a: a is None)


@pytest.fixture(scope="module")
def darknet():
    cfg = dataclasses.replace(yolact_model_config("yolact_darknet53"),
                              img_size=CANVAS)
    jcfg = _jcfg(cfg)
    rng = np.random.default_rng(6)
    imgs = rng.integers(0, 256, (2, *IMAGES_HW, 3), dtype=np.uint8)
    x = yolact_preprocess(torch.from_numpy(imgs), CANVAS)
    model = Y.build_model(cfg)
    model.load_state_dict(synthetic_yolact_state_dict(model, 6), strict=True)
    calibrate_yolact_gate(model, x)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    upstream = {k: v.numpy() for k, v in upstream_state_dict(
        model.state_dict()).items()}
    params = jax.tree.map(
        lambda a: None if a is None else jnp.asarray(a),
        from_torch_state(upstream, jcfg),
        is_leaf=lambda a: a is None or isinstance(a, np.ndarray))
    port = Y.build_model(cfg)
    port.load_state_dict(yolact_state_dict_from_jax(_np(params), cfg),
                         strict=True)
    with torch.inference_mode():
        preds = port(x)
    jpreds = jax.jit(lambda p, im: JY.forward(
        p, j_preprocess(im, size=CANVAS), jcfg))(params, jnp.asarray(imgs))
    return {"cfg": cfg, "jcfg": jcfg, "sd": sd, "upstream": upstream,
            "params": params, "port": port, "preds": preds,
            "jpreds": {k: np.array(v) for k, v in jpreds.items()}}


def test_darknet_model_and_tree_keys(darknet):
    """The backbone is nn/darknet.py's DarkNet-53 with C3-C5 taps of 256,
    512 and 1024 channels; the JAX tree maps onto the state_dict key for
    key, bit for bit."""
    port = darknet["port"]
    assert type(port.backbone).__name__ == "DarkNet53"
    assert [c.in_channels for c in port.fpn.lat_layers] == [1024, 512, 256]
    back = yolact_state_dict_from_jax(_np(darknet["params"]), darknet["cfg"])
    assert back.keys() == darknet["sd"].keys()
    for k, v in darknet["sd"].items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_darknet_forward_matches_jax(darknet):
    for k in ("loc", "conf", "coeff", "proto"):
        got, want = darknet["preds"][k].numpy(), darknet["jpreds"][k]
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=k)


def test_darknet_forward_and_detect_match_jax(darknet):
    cfg, jcfg = darknet["cfg"], darknet["jcfg"]
    with torch.inference_mode():
        got = Y.detect(darknet["preds"], torch.from_numpy(
            Y.make_priors_np(cfg)), cfg)
    want = jax.jit(lambda p, pr: JY.detect(p, pr, jcfg))(
        {k: jnp.asarray(v) for k, v in darknet["jpreds"].items()},
        jnp.asarray(JY.make_priors_np(jcfg)))
    _assert_same_detections(got, want, maskiou=False)


def test_tpuseg_torch_state_loads_into_the_port(darknet, tmp_path):
    """tpuseg's ``to_torch_state`` (upstream's DarkNet keys) written as a
    .pth: ``load_yolact_weights`` maps it onto the port, strict=True."""
    flat = to_torch_state(_np(darknet["params"]), darknet["jcfg"])
    assert "backbone._preconv.conv.weight" in flat
    assert "backbone.layers.4.4.1.bn.running_var" in flat
    path = tmp_path / "yolact_darknet53_1_2.pth"
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in flat.items()},
               path)
    model = Y.build_model(darknet["cfg"])
    model.load_state_dict(load_yolact_weights(str(path)), strict=True)
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), darknet["sd"][k], err_msg=k)


def test_port_checkpoint_reads_in_tpuseg(darknet, tmp_path):
    """``save_yolact_checkpoint`` writes upstream's keys: the file reads
    back through tpuseg's ``load_params_ckpt`` to the same tree."""
    path = str(tmp_path / "yolact_darknet53_0_1.pth")
    TT.save_yolact_checkpoint(path, darknet["port"])
    saved = torch.load(path, weights_only=True)
    assert saved.keys() == darknet["upstream"].keys()
    params = JT.load_params_ckpt(path, None, darknet["jcfg"])
    got, want = (jax.tree_util.tree_leaves_with_path(_np(t))
                 for t in (params, darknet["params"]))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w, err_msg=str(p))


def test_darknet_npz_both_ways(darknet, tmp_path):
    """The port's npz of the tree equals tpuseg's tree read by its own
    ``load_params_npz``, and reads back through the port's reader."""
    path = str(tmp_path / "yolact_darknet53_0_1.npz")
    save_params_npz(path, yolact_jax_from_state_dict(
        darknet["port"].state_dict(), darknet["cfg"]))
    params = JT.load_params_npz(path, darknet["params"])
    for (p, g), (_, w) in zip(
            jax.tree_util.tree_leaves_with_path(_np(params)),
            jax.tree_util.tree_leaves_with_path(_np(darknet["params"]))):
        np.testing.assert_array_equal(g, w, err_msg=str(p))
    back = yolact_state_dict_from_jax(load_params_npz(path), darknet["cfg"])
    for k, v in darknet["sd"].items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_freeze_bn_covers_darknet(darknet):
    """``freeze_bn`` (a batch below 6) keeps DarkNet's BatchNorms in eval
    mode under ``train()``, as ResNet's."""
    model = Y.build_model(darknet["cfg"])
    model.freeze_bn = True
    model.train()
    bns = [m for m in model.modules() if isinstance(m, DarkNetBN)]
    assert len(bns) == 52 and not any(m.training for m in bns)
    model.freeze_bn = False
    model.train()
    assert all(m.training for m in bns)
