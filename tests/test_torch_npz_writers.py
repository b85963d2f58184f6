"""The port's npz writers for the detectron (FPN, Faster R-CNN, C4,
RetinaNet), YOLACT and Pose2Seg trees, on the CPU: from one upstream-keyed
numpy state_dict, tpuseg's own reader gives its tree and the port's model
its state_dict; the port's ``*_jax_from_state_dict`` written by its
``save_params_npz`` is read by tpuseg's ``load_params_npz`` on tpuseg's tree
with every array equal, and reads back through the port's reader to the
same state_dict; ``save_pose2seg_checkpoint`` with an ``.npz`` path too
(the detectron loop's and ``yolact_train``'s npz are held in their CLI
tests)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from chip_smoke import synthetic_yolact_state_dict
from tests.test_cross_parity import NC
from tests.test_cross_parity import _synth_state as fpn_state
from tests.test_cross_parity_c4 import _synth_state as c4_state
from tests.test_cross_parity_retinanet import _synth_state as rn_state
from tests.test_torch_npz_io import assert_trees_equal
from tests.test_torch_pose2seg import jax_tree as pose2seg_tree
from tpuseg.engine.trainer import load_params_npz as j_load_npz
from tpuseg.models import maskrcnn as JM
from tpuseg.models import maskrcnn_c4 as JC4
from tpuseg.models import retinanet as JRN
from tpuseg.models import yolact as JY
from tpuseg.weights import detectron_map as JDM
from tpuseg.weights import yolact_map as JYM
from tpuseg_torch.configs.presets import yolact_model_config
from tpuseg_torch.engine.detectron_train_loop import jax_tree
from tpuseg_torch.engine.maskrcnn_engine import build_model
from tpuseg_torch.engine.pose2seg_engine import save_pose2seg_checkpoint
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_c4 as C4
from tpuseg_torch.models import pose2seg as P2S
from tpuseg_torch.models import retinanet as RN
from tpuseg_torch.models import yolact as Y
from tpuseg_torch.weights import from_jax
from tpuseg_torch.weights.npz_io import load_params_npz, save_params_npz
from tpuseg_torch.weights.pose2seg_map import load_pose2seg_weights

torch.set_num_threads(2)


def _no_mask(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if not k.startswith("roi_heads.mask")}


def _detectron(cfg, jcfg, sd, jax_reader, port_reader):
    model = build_model(cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return {"want": jax_reader(sd, jcfg), "model": model,
            "write": lambda m: jax_tree(m), "read": port_reader}


def _case(family: str) -> dict:
    """-> tpuseg's tree of the numpy weights (``want``), the port's model of
    the same weights, its tree writer and the port's tree reader."""
    rng = np.random.default_rng(9)
    if family in ("fpn", "faster_rcnn_fpn"):
        mask_on = family == "fpn"
        sd = fpn_state(rng)
        sd = sd if mask_on else _no_mask(sd)
        cfg = M.MaskRCNNConfig(num_classes=NC, mask_on=mask_on)
        return _detectron(cfg, JM.MaskRCNNConfig(num_classes=NC,
                                                 mask_on=mask_on), sd,
                          JDM.from_torch_state,
                          lambda t: from_jax.state_dict_from_jax(t, cfg))
    if family in ("c4", "faster_rcnn_c4"):
        mask_on = family == "c4"
        sd = c4_state(rng)
        sd = sd if mask_on else _no_mask(sd)
        return _detectron(C4.MaskRCNNC4Config(num_classes=NC, mask_on=mask_on),
                          JC4.MaskRCNNC4Config(num_classes=NC,
                                               mask_on=mask_on),
                          sd, JC4.from_torch_state,
                          from_jax.c4_state_dict_from_jax)
    if family == "retinanet":
        return _detectron(RN.RetinaNetConfig(num_classes=NC),
                          JRN.RetinaNetConfig(num_classes=NC), rn_state(rng),
                          JRN.from_torch_state,
                          from_jax.retinanet_state_dict_from_jax)
    if family == "yolact_plus_resnet50":
        cfg = dataclasses.replace(yolact_model_config(family), img_size=64)
        jcfg = JY.YolactConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})
        model = Y.build_model(cfg)
        model.load_state_dict(synthetic_yolact_state_dict(model, 9))
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
        return {"want": JYM.from_torch_state(sd, jcfg), "model": model,
                "write": lambda m: from_jax.yolact_jax_from_state_dict(
                    m.state_dict(), cfg),
                "read": lambda t: from_jax.yolact_state_dict_from_jax(t, cfg)}
    assert family == "pose2seg"
    tree = pose2seg_tree(rng, P2S.Pose2SegConfig(seg_units=2))
    sd = from_jax.pose2seg_state_dict_from_jax(tree)
    model = torch.nn.Module()  # only its state_dict is written
    model.state_dict = lambda: sd
    return {"want": tree, "model": model,
            "write": lambda m: from_jax.pose2seg_jax_from_state_dict(
                m.state_dict()),
            "read": from_jax.pose2seg_state_dict_from_jax}


@pytest.mark.parametrize("family", ["fpn", "faster_rcnn_fpn", "c4",
                                    "faster_rcnn_c4", "retinanet",
                                    "yolact_plus_resnet50", "pose2seg"])
def test_port_npz_is_tpuseg_tree(tmp_path, family):
    case = _case(family)
    want = jax.tree.map(lambda a: None if a is None else np.asarray(a),
                        case["want"], is_leaf=lambda a: a is None)
    path = str(tmp_path / f"{family}.npz")
    save_params_npz(path, case["write"](case["model"]))
    got = j_load_npz(path, want)
    n = assert_trees_equal(got, want)
    with np.load(path) as f:
        assert len(f.files) == n  # nothing the JAX tree lacks
    sd = case["model"].state_dict()
    back = case["read"](load_params_npz(path))
    assert back.keys() == sd.keys()
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_pose2seg_checkpoint_npz_by_suffix(tmp_path):
    """``save_pose2seg_checkpoint`` writes the JAX tree for an ``.npz``
    path (``pose2seg_train --save x.npz``) and the state_dict otherwise;
    ``load_pose2seg_weights`` reads both to the same state_dict."""
    cfg = P2S.Pose2SegConfig(seg_units=2)
    tree = pose2seg_tree(np.random.default_rng(4), cfg)
    sd = from_jax.pose2seg_state_dict_from_jax(tree)
    model = torch.nn.Module()
    model.state_dict = lambda: sd
    for name in ("last.npz", "last.pth"):
        save_pose2seg_checkpoint(str(tmp_path / name), model)
    assert_trees_equal(j_load_npz(str(tmp_path / "last.npz"), tree), tree)
    for name in ("last.npz", "last.pth"):
        got, _ = load_pose2seg_weights(str(tmp_path / name), cfg)
        for k, v in sd.items():
            assert torch.equal(got[k], v), (name, k)
