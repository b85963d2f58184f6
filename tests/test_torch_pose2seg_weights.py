"""tpuseg_torch's Pose2Seg ``last.pkl`` loader against tpuseg's, on the CPU:
synthetic upstream checkpoints written by tpuseg's ``save_torch_file`` in
each key layout the loaders take, read by both (the port's state_dict
equal to tpuseg's tree through ``weights/from_jax.py``), partial
checkpoints refused by both, and the port's own checkpoint read back."""
import functools

import numpy as np
import pytest
import torch

from tests.test_torch_pose2seg import WIDTH, jax_tree
from tpuseg.engine import pose2seg_engine as JE
from tpuseg.models import pose2seg as JP
from tpuseg.weights.torch_io import save_torch_file
from tpuseg_torch.engine import pose2seg_engine as TE
from tpuseg_torch.models import pose2seg as TP
from tpuseg_torch.weights.from_jax import pose2seg_state_dict_from_jax
from tpuseg_torch.weights.pose2seg_map import load_pose2seg_weights

torch.set_num_threads(2)

UNITS = 3


@pytest.fixture(scope="module")
def upstream():
    """An upstream-keyed Pose2Seg state dict (numpy): the port's keys, a
    ResNet of stem width 16, the 256-channel FPN and a 311-channel segnet
    of 3 units, random values, num_batches_tracked 7."""
    cfg = TP.Pose2SegConfig(seg_units=UNITS)
    sd = pose2seg_state_dict_from_jax(jax_tree(np.random.default_rng(3), cfg))
    return {k: (np.asarray(7, np.int64) if k.endswith("num_batches_tracked")
                else v.numpy()) for k, v in sd.items()}


def _layout(sd: dict, layout: str) -> dict:
    """The same tensors under another of the layouts both loaders take."""
    res, fpn, stem, units, extra = {
        "inlined": ("backbone.", "backbone.", "conv1", "layers", ""),
        "nested": ("backbone.resnet.", "backbone.fpn.", "stem", "res.units",
                   ""),
        "module": ("backbone.resnet50.", "backbone.", "conv_in", "layers",
                   "module."),
        "nested_twice": ("backbone.backbone.", "backbone.fpn.", "conv1",
                         "blocks", ""),
    }[layout]
    stems = {"conv1": ("conv1", "bn1"), "stem": ("stem.0", "stem.1"),
             "conv_in": ("conv_in", "bn_in")}[stem]
    out = {}
    for k, v in sd.items():
        if layout == "module" and k.startswith(("backbone.smooth1.",
                                                "backbone.smooth2.")):
            continue  # unused by P2: absent from some checkpoints
        if layout == "nested_twice" and k.endswith("num_batches_tracked"):
            continue  # older torch wrote none
        if k.startswith("segnet."):
            k = (k.replace("segnet.conv1.", f"segnet.{stems[0]}.")
                 .replace("segnet.bn1.", f"segnet.{stems[1]}.")
                 .replace("segnet.layers.", f"segnet.{units}."))
        elif k.startswith(("backbone.toplayer", "backbone.latlayer",
                           "backbone.smooth")):
            k = fpn + k.removeprefix("backbone.")
        else:
            k = res + k.removeprefix("backbone.")
        out[extra + k] = v
    return out


@pytest.mark.parametrize("layout", ["inlined", "nested", "module",
                                    "nested_twice"])
def test_last_pkl_loads_as_tpuseg_loads_it(upstream, layout, tmp_path):
    """The port's state_dict equals tpuseg's tree (through from_jax), every
    tensor; cat_skeleton inferred from the 311 input channels; smooth1 and
    smooth2 zeros where absent; num_batches_tracked kept, or 0 where
    absent; the model loads it strictly."""
    path = str(tmp_path / "last.pkl")
    save_torch_file(path, _layout(upstream, layout))
    tree, jcfg = JE.load_pose2seg_weights(path, JP.Pose2SegConfig())
    want = pose2seg_state_dict_from_jax(tree)
    got, cfg = load_pose2seg_weights(path, TP.Pose2SegConfig(
        cat_skeleton=False))
    assert jcfg.cat_skeleton and cfg.cat_skeleton and cfg.seg_units == UNITS
    assert got.keys() == want.keys()
    for k, v in got.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == (0 if layout == "nested_twice" else 7), k
            continue
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    if layout == "module":
        assert not got["backbone.smooth1.weight"].any()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "ResNetFPN", functools.partial(TP.ResNetFPN,
                                                       width=WIDTH))
        TP.build_model(cfg).load_state_dict(got, strict=True)


def _drop(sd, *prefixes):
    return {k: v for k, v in sd.items() if not k.startswith(prefixes)}


PARTIAL = {
    # the segnet stem without its units
    "no_units": lambda sd: _drop(sd, "segnet.layers.", "segnet.conv2."),
    # a key neither loader maps
    "leftover": lambda sd: {**sd, "segnet.extra.weight": np.zeros(3)},
    # an FPN conv on the P2 path missing
    "no_latlayer2": lambda sd: _drop(sd, "backbone.latlayer2."),
    # a segnet input that is neither 256 nor 256 + 55 channels
    "segnet_in": lambda sd: {**sd, "segnet.conv1.weight":
                             sd["segnet.conv1.weight"][:, :300]},
}


@pytest.mark.parametrize("case", sorted(PARTIAL))
def test_partial_checkpoint_refused_as_tpuseg_refuses_it(upstream, case,
                                                         tmp_path):
    path = str(tmp_path / f"{case}.pkl")
    save_torch_file(path, PARTIAL[case](upstream))
    with pytest.raises(ValueError):
        JE.load_pose2seg_weights(path, JP.Pose2SegConfig())
    with pytest.raises(ValueError):
        load_pose2seg_weights(path, TP.Pose2SegConfig())


def test_port_checkpoint_round_trip(tmp_path):
    """A model saved by the port's checkpoint writer loads back through the
    loader into the predictor, every tensor equal; the JAX params' npz is
    read too, as tpuseg's loader reads it, its config unchanged
    (tests/test_torch_npz_io.py holds it tensor by tensor)."""
    cfg = TP.Pose2SegConfig(input_size=64, seg_units=2, cat_skeleton=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "ResNetFPN", functools.partial(TP.ResNetFPN,
                                                       width=WIDTH))
        model = TP.build_model(cfg, torch.Generator().manual_seed(1))
        path = str(tmp_path / "pose2seg_last.pth")
        TE.save_pose2seg_checkpoint(path, model)
        pred = TE.Pose2SegPredictor(TP.Pose2SegConfig(input_size=64),
                                    weights=path, device="cpu")
    assert not pred.cfg.cat_skeleton and pred.cfg.seg_units == 2
    for k, v in model.state_dict().items():
        assert torch.equal(pred.model.state_dict()[k], v), k
    from tpuseg.engine.trainer import save_params_npz

    tree = jax_tree(np.random.default_rng(9), cfg)
    save_params_npz(str(tmp_path / "params.npz"), tree)
    sd, cfg2 = load_pose2seg_weights(str(tmp_path / "params.npz"), cfg)
    assert cfg2 == cfg
    assert torch.equal(sd["segnet.conv2.weight"], pose2seg_state_dict_from_jax(
        tree)["segnet.conv2.weight"])
