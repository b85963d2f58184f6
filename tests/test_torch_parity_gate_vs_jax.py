"""The port's parity-gate runners against tpuseg's on the CPU, family by
family, in smoke mode: one smoke dataset on disk (the port's writer) read
by both; tpuseg's runner with its predictor's ``init_params(PRNGKey(0),
cfg)``, the port's runner with those params carried over by
``weights/from_jax.py``.

What each evaluation scores is held detection by detection: the results
handed to ``loadRes`` (YOLACT: each image's ``postprocess_image``) in the
same order, with equal image ids, categories and masks, boxes within
BOX_TOL pixels and scores within SCORE_TOL. The measured dicts must then
be equal or within 1e-3 of a percent point (the smoke's phase-13 rule).

Random init_params drive the heads of five families into saturation on
these images (every score 1.0, boxes pinned to the image's edges), so
their mAP is 0 on both sides and counts sit at their caps: there the
per-detection check carries the comparison, and what it cannot see
(each runner's score threshold and label map) is held by
``test_torch_parity_gate.py::test_runner_builds_as_tpusegs``. Pose2Seg
scores the ground-truth people and measures a nonzero mAP, held equal
too. One case a family, so that each family's XLA compile stays in its
own case (YOLACT's, the heaviest, ~18 s here)."""
import argparse
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tools.parity_gate as JPG
from tpuseg.engine import maskrcnn_engine as JME
from tpuseg.engine import pose2seg_engine as JP2SE
from tpuseg.engine import yolact_engine as JYE
from tpuseg.engine import yolo_engine as JYOE
from tpuseg.eval.coco import COCO as JCOCO
from tpuseg_torch.engine import yolact_engine as YE
from tpuseg_torch.eval.coco import COCO
from tpuseg_torch.models.maskrcnn import MaskRCNNConfig
from tpuseg_torch.models.yolact import YolactConfig
from tpuseg_torch.tools import parity_gate as PG
from tpuseg_torch.weights import from_jax as FJ

torch.set_num_threads(2)

TOL = 1e-3  # percent points, at equal detection counts
# measured: boxes 1.5e-5 px apart at most (Mask R-CNN FPN), scores equal
BOX_TOL = 1e-3
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def smoke_args(tmp_path_factory):
    images, ann = PG.write_smoke_dataset(str(tmp_path_factory.mktemp("ds")))
    return dict(weights_dir="weights", coco_images=images, coco_ann=ann,
                ochuman_images=None, ochuman_val=None, max_images=2,
                batch_size=8, only=None, smoke=True)


class Spy:
    """Wraps ``owner.name`` for the rest of the test (``mp``, its
    monkeypatch) and keeps, of each call, the instance built (for
    ``__init__``) or ``count(result, *args)``."""

    def __init__(self, mp, owner, name, count=None):
        self.seen = []
        orig = getattr(owner, name)

        def run(*args, **kwargs):
            out = orig(*args, **kwargs)
            self.seen.append(args[0] if count is None else
                             count(out, *args))
            return out

        mp.setattr(owner, name, run)


def port_config(cls, jcfg):
    """The port's config class with tpuseg's config's values."""
    return cls(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(cls)})


def carried_over(name: str, jpred) -> dict:
    """tpuseg's predictor params as the port's state dict."""
    params = jax.tree.map(np.asarray, jpred.params)
    if name == "yolact_r50_550":
        return FJ.yolact_state_dict_from_jax(
            params, port_config(YolactConfig, jpred.cfg))
    if name == "mask_rcnn_r50_fpn":
        return FJ.state_dict_from_jax(
            params, port_config(MaskRCNNConfig, jpred.cfg))
    if name == "mask_rcnn_r50_c4":
        return FJ.c4_state_dict_from_jax(params)
    if name == "retinanet_r50":
        return FJ.retinanet_state_dict_from_jax(params)
    if name == "yolov3_608":
        return FJ.yolov3_state_dict_from_jax(params)
    return FJ.pose2seg_state_dict_from_jax(params)


# family -> tpuseg's predictor class
PREDICTORS = {
    "yolact_r50_550": JYE.YolactPredictor,
    "mask_rcnn_r50_fpn": JME.MaskRCNNPredictor,
    "mask_rcnn_r50_c4": JME.MaskRCNNPredictor,
    "retinanet_r50": JME.MaskRCNNPredictor,
    "yolov3_608": JYOE.YoloPredictor,
    "pose2seg": JP2SE.Pose2SegPredictor,
}


def scored(mp, name: str) -> tuple:
    """Spies that keep what each side's evaluation scores: YOLACT's
    detections of each image from postprocess_image, the others' results
    as handed to loadRes."""
    if name == "yolact_r50_550":
        return tuple(Spy(mp, cls, "postprocess_image", lambda out, *a: out)
                     for cls in (JYE.YolactPredictor, YE.YolactPredictor))
    return tuple(Spy(mp, cls, "loadRes", lambda out, self, res: res)
                 for cls in (JCOCO, COCO))


def require_same_results(got: list, want: list) -> None:
    """loadRes's results, call by call and detection by detection."""
    assert [len(r) for r in got] == [len(r) for r in want]
    for g, w in zip((d for r in got for d in r), (d for r in want for d in r)):
        assert g.keys() == w.keys(), (g, w)
        assert (g["image_id"], g["category_id"], g.get("segmentation")) == (
            w["image_id"], w["category_id"], w.get("segmentation")), (g, w)
        assert abs(g["score"] - w["score"]) <= SCORE_TOL, (g, w)
        if "bbox" in w:
            assert np.abs(np.subtract(g["bbox"], w["bbox"])).max() <= \
                BOX_TOL, (g, w)


def require_same_detections(got: list, want: list) -> None:
    """YOLACT's per-image detections: boxes (integer pixels), classes and
    masks equal, scores within SCORE_TOL."""
    assert [len(d["scores"]) for d in got] == [len(d["scores"])
                                                for d in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("boxes", "classes", "masks"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=0,
                                   atol=SCORE_TOL)


@pytest.mark.parametrize("name", [f["name"] for f in PG.FAMILIES])
def test_runner_matches_tpuseg_on_its_weights(name, smoke_args, monkeypatch):
    jbuilt = Spy(monkeypatch, PREDICTORS[name], "__init__")
    jscored, scored_ = scored(monkeypatch, name)
    want = JPG.RUNNERS[name]("unused", argparse.Namespace(**smoke_args),
                             True)
    (jpred,) = jbuilt.seen
    sd = carried_over(name, jpred)
    got = PG.RUNNERS[name]("unused", argparse.Namespace(
        **smoke_args, device="cpu"), True, state_dict=sd)

    assert got.keys() == want.keys(), (got, want)
    assert all(0.0 <= v <= 100.0 for v in got.values()), got
    # measured on these weights: YOLACT 10 and 3 detections on the two
    # images, Mask R-CNN FPN 7, C4 2, RetinaNet 16, YOLOv3 200, Pose2Seg 3
    # people, on both sides
    assert scored_.seen and jscored.seen
    if name == "yolact_r50_550":
        assert sum(len(d["scores"]) for d in scored_.seen)
        require_same_detections(scored_.seen, jscored.seen)
    else:
        assert sum(map(len, scored_.seen))
        require_same_results(scored_.seen, jscored.seen)
    diff = max(abs(got[k] - want[k]) for k in want)
    assert diff <= TOL, (name, got, want)
    if name == "pose2seg":  # the one family whose mAP is not 0 here
        assert want["mask"] > 0, want
