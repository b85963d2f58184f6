"""Weight loading of the rest of the detectron family in tpuseg_torch: C4
checkpoints with and without the mask head's duplicate of the shared res5
(``roi_heads.mask.feature_extractor.*``), boxes-only (Faster R-CNN FPN and
C4) and RetinaNet checkpoints, all strict; the JAX trees round trip to the
same state dicts; and the solver's parameter groups by module name."""
import numpy as np
import pytest
import torch

from tests.test_cross_parity import _synth_state as fpn_state
from tests.test_cross_parity_c4 import NC, _synth_state as c4_state
from tests.test_cross_parity_retinanet import _synth_state as rn_state
from tpuseg.models import maskrcnn_c4 as JC4
from tpuseg.models import retinanet as JRN
from tpuseg_torch.engine.maskrcnn_engine import MaskRCNNPredictor
from tpuseg_torch.engine.trainer import detectron_param_groups
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.models import maskrcnn_c4 as C4
from tpuseg_torch.models import retinanet as RN
from tpuseg_torch.weights.detectron_map import load_detectron_weights
from tpuseg_torch.weights.from_jax import (c4_state_dict_from_jax,
                                           retinanet_state_dict_from_jax)

SHARED = "roi_heads.mask.feature_extractor.head.layer4."
BOX = "roi_heads.box.feature_extractor.head.layer4."


@pytest.fixture(scope="module")
def c4_sd():
    return c4_state(np.random.default_rng(5))


def _save(path, sd: dict, prefix: str = "") -> str:
    torch.save({"model": {prefix + k: torch.from_numpy(np.asarray(v))
                          for k, v in sd.items()}, "iteration": 1}, path)
    return str(path)


def _assert_loaded(model, sd: dict) -> None:
    got = model.state_dict()
    assert got.keys() == {k for k in sd if not k.startswith(
        ("roi_heads.mask.feature_extractor.", "rpn.anchor_generator."))}
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(sd[k]), err_msg=k)


@pytest.mark.parametrize("duplicate", [False, True])
def test_c4_checkpoint_loads_with_and_without_the_shared_res5_copy(
        c4_sd, tmp_path, duplicate):
    """Upstream's SHARE_BOX_FEATURE_EXTRACTOR saves res5 under the mask
    head too; the loader checks the copy equals the box head's and drops
    it."""
    sd = dict(c4_sd)
    if duplicate:
        sd.update({SHARED + k[len(BOX):]: v.copy() for k, v in c4_sd.items()
                   if k.startswith(BOX)})
        assert sum(k.startswith(SHARED) for k in sd) == sum(
            k.startswith(BOX) for k in sd) == 50
    model = load_detectron_weights(
        _save(tmp_path / "c4.pth", sd, "module."),
        C4.build_model(C4.MaskRCNNC4Config(num_classes=NC)))
    _assert_loaded(model, sd)


def test_c4_checkpoint_with_a_differing_copy_is_refused(c4_sd, tmp_path):
    sd = dict(c4_sd)
    sd.update({SHARED + k[len(BOX):]: v.copy() for k, v in c4_sd.items()
               if k.startswith(BOX)})
    sd[SHARED + "0.conv1.weight"] = sd[SHARED + "0.conv1.weight"] + 1.0
    with pytest.raises(ValueError, match="differs"):
        load_detectron_weights(
            _save(tmp_path / "c4.pth", sd),
            C4.build_model(C4.MaskRCNNC4Config(num_classes=NC)))


def test_boxes_only_checkpoints_load(c4_sd, tmp_path):
    """Faster R-CNN C4 and FPN: no roi_heads.mask.* in the checkpoint, nor
    in the model; a Mask R-CNN model refuses the boxes-only checkpoint."""
    sd = {k: v for k, v in c4_sd.items() if not k.startswith("roi_heads.mask")}
    model = load_detectron_weights(
        _save(tmp_path / "c4.pth", sd),
        C4.build_model(C4.MaskRCNNC4Config(num_classes=NC, mask_on=False)))
    _assert_loaded(model, sd)
    fsd = {k: v for k, v in fpn_state(np.random.default_rng(6)).items()
           if not k.startswith("roi_heads.mask")}
    path = _save(tmp_path / "fpn.pth", fsd)
    model = load_detectron_weights(path, M.build_model(
        M.MaskRCNNConfig(num_classes=NC, mask_on=False)))
    _assert_loaded(model, fsd)
    with pytest.raises(RuntimeError, match="Missing key"):
        load_detectron_weights(path, M.build_model(
            M.MaskRCNNConfig(num_classes=NC)))


def test_mask_checkpoint_into_a_boxes_only_fpn_model_names_its_keys(
        tmp_path):
    """The FPN mask head's ``roi_heads.mask.feature_extractor.mask_fcn*``
    have no box twin: the strict load refuses them by name, and the
    shared-res5 check stays out of it."""
    path = _save(tmp_path / "fpn.pth", fpn_state(np.random.default_rng(6)))
    with pytest.raises(RuntimeError, match=r"Unexpected key.*roi_heads\.mask"
                       r"\.feature_extractor\.mask_fcn1"):
        load_detectron_weights(path, M.build_model(
            M.MaskRCNNConfig(num_classes=NC, mask_on=False)))


def test_retinanet_checkpoint_loads(tmp_path):
    """With ``module.`` and the anchor generator's buffers, which are
    dropped; the predictor takes it through ``weights``."""
    sd = rn_state(np.random.default_rng(7))
    sd["rpn.anchor_generator.cell_anchors.0"] = np.zeros((9, 4), np.float32)
    path = _save(tmp_path / "retinanet.pth", sd, "module.")
    cfg = RN.RetinaNetConfig(num_classes=NC)
    _assert_loaded(load_detectron_weights(path, RN.build_model(cfg)), sd)
    pred = MaskRCNNPredictor(cfg, weights=path, device="cpu")
    assert pred.variant == "retinanet"
    np.testing.assert_array_equal(
        pred.model.rpn.head.cls_logits.weight.detach().numpy(),
        sd["rpn.head.cls_logits.weight"])


def test_jax_trees_round_trip_to_the_state_dicts(c4_sd):
    for mask_on in (True, False):
        sd = {k: v for k, v in c4_sd.items()
              if mask_on or not k.startswith("roi_heads.mask")}
        got = c4_state_dict_from_jax(JC4.from_torch_state(
            sd, JC4.MaskRCNNC4Config(num_classes=NC, mask_on=mask_on)))
        assert got.keys() == sd.keys()
        for k, v in sd.items():
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        C4.build_model(C4.MaskRCNNC4Config(num_classes=NC, mask_on=mask_on)
                       ).load_state_dict(got, strict=True)
    sd = rn_state(np.random.default_rng(8))
    got = retinanet_state_dict_from_jax(JRN.from_torch_state(
        sd, JRN.RetinaNetConfig(num_classes=NC)))
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    RN.build_model(RN.RetinaNetConfig(num_classes=NC)).load_state_dict(
        got, strict=True)


@pytest.mark.parametrize("build", [
    lambda: C4.build_model(C4.MaskRCNNC4Config(num_classes=NC)),
    lambda: RN.build_model(RN.RetinaNetConfig(num_classes=NC)),
    lambda: M.build_model(M.MaskRCNNConfig(num_classes=NC, mask_on=False)),
], ids=["c4", "retinanet", "faster_rcnn_fpn"])
def test_param_groups_by_module_name(build):
    """The solver's groups (tpuseg's detectron_param_groups): the stem and
    layer1 left out (FREEZE_CONV_BODY_AT 2), FrozenBN tensors are buffers,
    biases at twice the lr without decay; C4's res5 lives under roi_heads
    and trains."""
    model = build()
    weights, biases = detectron_param_groups(model, 0.01, 1e-4)
    ids = {id(p): n for n, p in model.named_parameters()}
    wn = {ids[id(p)] for p in weights["params"]}
    bn = {ids[id(p)] for p in biases["params"]}
    names = set(ids.values())
    frozen = {n for n in names if n.startswith(("backbone.body.stem.",
                                                "backbone.body.layer1."))}
    assert frozen and not (wn | bn) & frozen
    assert wn | bn == names - frozen
    assert all(n.endswith("bias") for n in bn)
    assert not any(n.endswith("bias") for n in wn)
    assert (biases["lr"], biases["weight_decay"]) == (0.02, 0.0)
    assert (weights["lr"], weights["weight_decay"]) == (0.01, 1e-4)
    assert not any("bn" in n.split(".")[-2] for n in names)
    if isinstance(model, C4.MaskRCNNC4):
        assert any(n.startswith("roi_heads.box.feature_extractor.head.layer4.")
                   for n in wn)
        assert "backbone.body.layer2.0.conv1.weight" in wn
        assert not any("layer4" in n for n in names
                       if n.startswith("backbone."))
