"""The port's parity gate (``tpuseg_torch/tools/parity_gate.py``) on the
CPU: its FAMILIES and smoke dataset are tpuseg's, its smoke mode measures
all six families, a family without weights is a SKIP row, a family that
raises is a FAILED row with the verdict FAIL and exit status 1, each
runner in either mode builds its predictor, dataset and evaluation as
tpuseg's does, and fixed measured rows print tpuseg's table and
verdicts."""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import tools.parity_gate as JPG
from tpuseg_torch.tools import parity_gate as PG

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
NAMES = [f["name"] for f in JPG.FAMILIES]
# measured on this CPU: the PIL and cv2 JPEGs decode equal (both libjpeg,
# quality 95, 4:2:0); two libjpeg builds may round an IDCT apart
JPEG_LEVELS = 2


def test_families_are_tpusegs():
    assert PG.FAMILIES == JPG.FAMILIES
    assert list(PG.RUNNERS) == list(JPG.RUNNERS) == NAMES


def test_smoke_dataset_is_tpusegs(tmp_path):
    """The annotation json key for key; the port's PIL JPEGs decode (by
    PIL and by cv2) within JPEG_LEVELS of tpuseg's cv2 ones."""
    got = PG.write_smoke_dataset(str(tmp_path / "port"))
    want = JPG.write_smoke_dataset(str(tmp_path / "tpuseg"))
    assert [os.path.basename(p) for p in got] == [
        os.path.basename(p) for p in want]
    assert json.loads(Path(got[1]).read_text()) == json.loads(
        Path(want[1]).read_text())
    files = sorted(os.listdir(want[0]))
    assert sorted(os.listdir(got[0])) == files == ["001.jpg", "002.jpg"]
    for f in files:
        ref = cv2.imread(f"{want[0]}/{f}")[..., ::-1].astype(int)
        for img in (np.asarray(Image.open(f"{got[0]}/{f}").convert("RGB")),
                    cv2.imread(f"{got[0]}/{f}")[..., ::-1]):
            assert img.shape == (128, 128, 3)
            assert np.abs(img.astype(int) - ref).max() <= JPEG_LEVELS, f


def test_smoke_measures_six_families(capsys):
    """tests/test_parity_gate.py's check, on the port with --device cpu."""
    rows = PG.main(["--smoke", "--device", "cpu"])
    assert [r[0] for r in rows] == NAMES
    for name, measured, _, note, _ in rows:
        assert measured is not None, f"{name}: {note}"
        for v in measured.values():
            assert 0.0 <= v <= 100.0
    out = capsys.readouterr().out
    assert "smoke mode: plumbing exercised" in out and "FAIL" not in out
    assert not PG.failed(rows)


def test_empty_weights_dir_skips_every_family(tmp_path, capsys):
    """Where tpuseg's gate dies unpacking its SKIP row: six SKIP rows, no
    PASS, and main returns."""
    rows = PG.main(["--weights_dir", str(tmp_path), "--device", "cpu"])
    assert rows == [(f["name"], None, f["expect"], "SKIP (no weights)",
                     f["tol"]) for f in JPG.FAMILIES]
    out = capsys.readouterr().out
    assert out.count("SKIP (no weights)") == 6
    assert "-> NO VERDICT (no family measured)" in out
    assert "PASS" not in out and not PG.failed(rows)


def test_pose2seg_without_data_skips(tmp_path, monkeypatch):
    (tmp_path / "last.pkl").touch()
    monkeypatch.setitem(PG.RUNNERS, "pose2seg", pytest.fail)
    rows = PG.main(["--weights_dir", str(tmp_path), "--only", "pose2seg"])
    assert rows == [("pose2seg", None, {}, "SKIP (no data)", 0.1)]


def test_default_device_is_the_card(monkeypatch, capsys):
    """Without --device the families run on the card; on a machine without
    one each predictor raises, and the gate reports FAILED and FAIL rather
    than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = PG.main(["--smoke", "--only", "pose2seg,yolov3_608"])
    assert [r[0] for r in rows] == ["yolov3_608", "pose2seg"]
    for _, measured, _, note, _ in rows:
        assert measured is None and note.startswith("FAILED: ")
        assert "CUDA is unavailable" in note
    assert PG.failed(rows) == ["yolov3_608", "pose2seg"]
    assert "FAIL: yolov3_608, pose2seg raised" in capsys.readouterr().out


def test_raising_family_fails_the_run_as_main():
    """As ``__main__`` in a subprocess, YOLOv3's evaluation made to raise:
    its row FAILED, Pose2Seg's measured, the table printed, the verdict
    FAIL, exit status 1."""
    code = (
        "import runpy, sys\n"
        "from tpuseg_torch.engine import yolo_engine\n"
        "def boom(*a, **k):\n"
        "    raise RuntimeError('injected fault')\n"
        "yolo_engine.evaluate_coco_boxes = boom\n"
        "sys.argv = ['parity_gate', '--smoke', '--device', 'cpu',\n"
        "            '--only', 'yolov3_608,pose2seg']\n"
        "runpy.run_module('tpuseg_torch.tools.parity_gate',\n"
        "                 run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=240)
    out = proc.stdout
    assert proc.returncode == 1, (out, proc.stderr)
    table = out[out.index("family  "):]
    assert "yolov3_608            -              -        -       -  " \
           "FAILED: injected fault" in table
    assert "pose2seg              mask " in table
    assert "FAIL: yolov3_608 raised" in table and "PASS" not in table


def test_runs_by_path(tmp_path):
    """``python tpuseg_torch/tools/parity_gate.py`` from another directory:
    its own imports resolve, every family skips, exit status 0."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tpuseg_torch/tools/parity_gate.py"),
         "--weights_dir", str(ROOT / "no_such_dir"), "--device", "cpu"],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""},
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.count("SKIP (no weights)") == 6


class Built(Exception):
    """Raised by a stub predictor once it has recorded its arguments."""


# fields of tpuseg's configs the port does not have: the TPU's approx_topk,
# and two that nothing reads (rpn_min_size, Pose2Seg's feature_stride)
JAX_ONLY_FIELDS = {"approx_topk", "rpn_min_size", "feature_stride"}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("smoke", [False, True], ids=["real", "smoke"])
def test_runner_builds_as_tpusegs(name, smoke, tmp_path, monkeypatch):
    """Each runner, in real mode and in smoke mode, builds its predictor,
    dataset and evaluation call as tpuseg's does: the config (where both
    runners pass none, the predictors' defaults) equal on every field both
    packages have, the weight file, the batch, the detectron canvas and
    score threshold, the dataset's files and label map, and the
    evaluation's image limit."""
    from tpuseg.data import coco_dataset as JCD
    from tpuseg.engine import maskrcnn_engine as JME
    from tpuseg.engine import pose2seg_engine as JP2SE
    from tpuseg.engine import yolact_engine as JYE
    from tpuseg.engine import yolo_engine as JYOE
    from tpuseg.models import maskrcnn_c4 as JC4
    from tpuseg.models import retinanet as JRN
    from tpuseg_torch.data import coco_dataset as CD
    from tpuseg_torch.engine import maskrcnn_engine as ME
    from tpuseg_torch.engine import pose2seg_engine as P2SE
    from tpuseg_torch.engine import yolact_engine as YE
    from tpuseg_torch.engine import yolo_engine as YOE

    images, ann = PG.write_smoke_dataset(str(tmp_path))
    args = dict(coco_images=images, coco_ann=ann, ochuman_images=None,
                ochuman_val=None, max_images=2 if smoke else None,
                batch_size=8)
    built = {"tpuseg": {}, "port": {}}

    def stub(side, what, raises=False):
        def record(*a, **kw):
            built[side][what] = (a, kw)
            if raises:
                raise Built
            return what
        return record

    for side, engines, data in (("tpuseg", (JYE, JME, JYOE, JP2SE), JCD),
                                ("port", (YE, ME, YOE, P2SE), CD)):
        monkeypatch.setattr(data, "CocoDetectionDataset",
                            stub(side, "dataset"))
        for mod, cls, ev in zip(engines, (
                "YolactPredictor", "MaskRCNNPredictor", "YoloPredictor",
                "Pose2SegPredictor"), ("evaluate_dataset", "evaluate_coco",
                                       "evaluate_coco_boxes",
                                       "evaluate_pose2seg")):
            monkeypatch.setattr(mod, cls, stub(side, "predictor"))
            monkeypatch.setattr(mod, ev, stub(side, "evaluation", True))
    for tool in (JPG, PG):
        with pytest.raises(Built):
            tool.RUNNERS[name]("w/" + name, argparse.Namespace(
                **args, device="cuda"), smoke)
    jbuilt, pbuilt = built["tpuseg"], built["port"]
    assert pbuilt["dataset"] == jbuilt["dataset"]
    assert pbuilt["evaluation"] == jbuilt["evaluation"] == (
        ("predictor", "dataset"),
        {"max_images": args["max_images"], "progress": not smoke})
    (ja, jkw), (pa, pkw) = jbuilt["predictor"], pbuilt["predictor"]
    assert pkw.pop("device") == "cuda" and pkw.pop("state_dict", None) is None
    jcfg = ja[0] if ja else jkw.pop("cfg", None)
    pcfg = pa[0] if pa else pkw.pop("cfg", None)
    if "variant" in jkw:  # the detectron family
        assert pkw.pop("model") is None
        # tpuseg's predictor's batch; both evaluate_coco default to 1
        assert jkw.pop("batch_size") == 1
        if jcfg is None:
            assert pcfg is None
            jcfg = {"fpn": JME.M.MaskRCNNConfig,
                    "c4": JC4.MaskRCNNC4Config,
                    "retinanet": JRN.RetinaNetConfig}[jkw["variant"]]()
            pcfg = ME.VARIANTS[pkw["variant"]][1]()
    elif name == "pose2seg" and jcfg is None:
        assert pcfg is None
        jcfg, pcfg = JP2SE.P2S.Pose2SegConfig(), P2SE.P2S.Pose2SegConfig()
    assert type(pcfg).__name__ == type(jcfg).__name__
    j, p = dataclasses.asdict(jcfg), dataclasses.asdict(pcfg)
    assert set(p) <= set(j) and set(j) - set(p) <= JAX_ONLY_FIELDS
    assert p == {k: j[k] for k in p}
    assert pkw == jkw


MEASURED = {  # measured values for every family: within tolerance
    "yolact_r50_550": {"box": 30.3, "mask": 27.7},
    "mask_rcnn_r50_fpn": {"box": 37.75, "mask": 34.2},
    "mask_rcnn_r50_c4": {"box": 35.6, "mask": 31.9},
    "retinanet_r50": {"box": 36.0},
    "yolov3_608": {"box": 32.1},
    "pose2seg": {"mask": 55.25},
}


@pytest.mark.parametrize("case,verdict", [
    ({}, "PASS"),
    ({"yolact_r50_550": {"box": 29.6, "mask": 28.0},
      "yolov3_608": {"box": 34.5}}, "ATTENTION"),
])
def test_table_is_tpusegs(case, verdict, tmp_path, monkeypatch, capsys):
    """Real mode with both tools' runners stubbed to fixed measurements:
    the same rows and, line for line, the same table, verdict and
    breaches."""
    for f in JPG.FAMILIES:
        (tmp_path / f["weight"]).touch()
    measured = {**MEASURED, **case}
    argv = ["--weights_dir", str(tmp_path), "--coco_images", "x",
            "--coco_ann", "y"]
    out = {}
    for tool in (JPG, PG):
        for name in NAMES:
            monkeypatch.setitem(tool.RUNNERS, name,
                                lambda w, a, s, name=name: measured[name])
        capsys.readouterr()
        out[tool] = (tool.main(argv), capsys.readouterr().out)
    assert out[PG] == out[JPG]
    assert f"-> {verdict} (per-row gate" in out[PG][1]


def test_failed_row_fails_the_verdict(tmp_path, monkeypatch, capsys):
    """Real mode, one family raising: its FAILED row in the table, the
    others measured, and FAIL where tpuseg's gate prints PASS."""
    for f in JPG.FAMILIES:
        (tmp_path / f["weight"]).touch()
    for name in NAMES:
        monkeypatch.setitem(PG.RUNNERS, name,
                            lambda w, a, s, name=name: MEASURED[name])

    def boom(*a):
        raise ValueError("bad checkpoint")

    monkeypatch.setitem(PG.RUNNERS, "mask_rcnn_r50_c4", boom)
    rows = PG.main(["--weights_dir", str(tmp_path), "--coco_images", "x",
                    "--coco_ann", "y"])
    out = capsys.readouterr().out
    assert PG.failed(rows) == ["mask_rcnn_r50_c4"]
    assert "mask_rcnn_r50_c4      -              -        -       -  " \
           "FAILED: bad checkpoint" in out
    assert "-> FAIL (per-row gate" in out and "PASS" not in out
    assert sum(r[1] is not None for r in rows) == 5
