"""The YOLOv3 and ViT entry points of tpuseg_torch on the CPU: each of the
five CLIs (and the parity gate) takes its JAX twin's flags plus
``--device``; the predictors,
trainers and CLIs default to the card; yolo_detect, yolo_eval and
vit_infer run through ``main(argv)`` on small images; yolo_train's batch
equals tpuseg's recipe; yolo_train and vit_train take 2 steps each and
write npz params that tpuseg's ``load_params_npz`` reads."""
import ast
import inspect
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tests.test_cross_parity_yolov3 import write_synth_weights
from tpuseg.engine.trainer import load_params_npz as j_load_npz
from tpuseg.models import yolov3 as JY
from tpuseg.nn import vit as JV
from tpuseg_torch.data.coco_dataset import CocoDetectionDataset
from tpuseg_torch.engine import config as C
from tpuseg_torch.engine.classify import ViTClassifier
from tpuseg_torch.engine.vit_train import ViTTrainer
from tpuseg_torch.engine.yolo_engine import YoloPredictor, YoloTrainer
from tpuseg_torch.nn.vit import ViTConfig
from tpuseg_torch.tools import (vit_infer, vit_train, yolo_detect, yolo_eval,
                                yolo_train)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CLIS = ("yolo_detect", "yolo_eval", "yolo_train", "vit_infer", "vit_train",
        "parity_gate")
SMALL_VIT = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2,
                 num_heads=4, mlp_dim=128, num_classes=10)


def flags(path: Path) -> dict:
    """Each ``add_argument`` flag of a CLI -> its default (source text)."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords}
            out[node.args[0].value] = kw.get("default", kw.get("required"))
    return out


@pytest.mark.parametrize("cli", CLIS)
def test_cli_flags_are_the_twins_plus_device(cli):
    got = flags(ROOT / "tpuseg_torch" / "tools" / f"{cli}.py")
    want = flags(ROOT / "tools" / f"{cli}.py")
    assert got == {**want, "--device": "'cuda'"}


def test_entry_points_default_to_the_card():
    for fn in (YoloPredictor.__init__, YoloTrainer.__init__,
               ViTClassifier.__init__, ViTTrainer.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        cfg = ViTConfig(**SMALL_VIT)
        for build in (YoloPredictor, YoloTrainer, ViTClassifier,
                      lambda: ViTTrainer(cfg)):
            with pytest.raises(RuntimeError, match="CUDA"):
                build()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A synthetic darknet .weights file, a 4-image COCO dataset (smoke's
    writer: 640x480 and 480x640 PNGs, ten objects and a crowd each) and a
    class-folder dataset of 2 classes x 3 images of 40x50."""
    root = tmp_path_factory.mktemp("cli")
    weights = str(root / "synth.weights")
    write_synth_weights(weights, np.random.default_rng(33))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "COCO_IMAGES", 4)
        img_dir, ann, _ = chip_smoke.write_coco_dataset(root / "coco", 5)
    rng = np.random.default_rng(6)
    for c in ("cat", "dog"):
        (root / "folders" / c).mkdir(parents=True)
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (40, 50, 3)).astype(
                np.uint8)).save(root / "folders" / c / f"{i}.png")
    return {"root": root, "weights": weights, "images": img_dir, "ann": ann}


@pytest.fixture
def small_vit(monkeypatch):
    monkeypatch.setitem(C._REGISTRY, "vit_small_config",
                        C.get_config("vit_b16_config").copy(SMALL_VIT))


def test_yolo_detect_and_eval_run_on_cpu(files, capsys):
    """yolo_detect on one image (64 px letterbox; the drawn image written)
    and yolo_eval over 2 images: COCOeval's 12 stats."""
    img = str(Path(files["images"]) / "000000000001.png")
    out = str(files["root"] / "det.png")
    dets = yolo_detect.main(["--image", img, "--weights", files["weights"],
                             "--img_size", "64", "--conf_thres", "0.2",
                             "--out", out, "--device", "cpu"])
    assert len(dets["scores"]) > 0 and Path(out).exists()
    assert (dets["boxes"][:, 2:] <= [640, 480]).all()
    assert "detections (conf > 0.2)" in capsys.readouterr().out
    stats = yolo_eval.main(["--weights", files["weights"], "--images",
                            files["images"], "--annotations", files["ann"],
                            "--img_size", "64", "--batch_size", "2",
                            "--max_images", "2", "--device", "cpu"])
    assert len(stats) == 12


def test_vit_infer_runs_on_cpu(tmp_path, small_vit, capsys):
    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(1).integers(
        0, 256, (45, 37, 3)).astype(np.uint8)).save(img)
    ids, probs = vit_infer.main(["--image", str(img), "--config",
                                 "vit_small_config", "--top_k", "3",
                                 "--device", "cpu"])
    assert len(ids) == 3 and np.all(np.diff(probs) <= 0)
    assert capsys.readouterr().out.count("top") == 3


def test_yolo_train_batch_matches_tpuseg_recipe(files):
    """tools/yolo_train.py's batch (cv2's downscale to fit twice the input,
    the ground truth into letterbox px) against the port's train_batch:
    hw, boxes and classes equal, the pixels within one level (the port's
    resize is cv2's twin)."""
    import cv2

    ds = CocoDetectionDataset(files["images"], files["ann"],
                              include_crowd=False)
    ids = ds.image_ids[:2]
    batch, hw, boxes, classes = yolo_train.train_batch(ds, ids, 64)
    for i, iid in enumerate(ids):
        img = ds.load_image(iid)
        gt = ds.load_target(iid, with_masks=False)
        h, w = img.shape[:2]
        s = min(128 / w, 128 / h, 1.0)
        img = cv2.resize(img, (int(w * s), int(h * s)))
        h, w = img.shape[:2]
        assert tuple(hw[i]) == (h, w)
        diff = np.abs(batch[i, :h, :w].astype(int) - img).max()
        assert diff <= 1 and not batch[i, h:].any() and not batch[i, :, w:].any()
        scale = 64 / max(h, w)
        bb = gt["boxes"] * s * scale
        bb[:, 0::2] += (64 - w * scale) / 2
        bb[:, 1::2] += (64 - h * scale) / 2
        g = len(gt["boxes"])
        assert g == chip_smoke.COCO_OBJECTS  # the crowd dropped
        np.testing.assert_allclose(boxes[i, :g], bb, rtol=1e-6)
        np.testing.assert_array_equal(classes[i, :g], gt["classes"])
        assert (classes[i, g:] == -1).all()


def test_yolo_train_writes_npz_tpuseg_reads(files):
    save = str(files["root"] / "yolov3.npz")
    losses = yolo_train.main(["--images", files["images"], "--annotations",
                              files["ann"], "--img_size", "64",
                              "--batch_size", "2", "--steps", "2",
                              "--save", save, "--device", "cpu"])
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    like = jax.eval_shape(lambda: JY.init_params(jax.random.PRNGKey(0),
                                                 JY.YoloV3Config()))
    params = j_load_npz(save, like)
    assert params["head2"]["out"]["weight"].shape == (1, 1, 256, 255)
    pred = YoloPredictor(weights=save, device="cpu")
    np.testing.assert_array_equal(
        pred.model.head2.out.weight.detach().numpy().transpose(2, 3, 1, 0),
        np.asarray(params["head2"]["out"]["weight"]))


@pytest.mark.parametrize("folders", [True, False])
def test_vit_train_writes_npz_tpuseg_reads(files, small_vit, folders):
    """2 steps from the class folders (num_classes 2) or synthetic data;
    the npz read by tpuseg's load_params_npz on its template."""
    save = str(files["root"] / f"vit_{folders}.npz")
    argv = ["--config", "vit_small_config", "--batch_size", "2", "--steps",
            "2", "--save", save, "--device", "cpu"]
    if folders:
        argv += ["--data_dir", str(files["root"] / "folders")]
    metrics = vit_train.main(argv)
    assert len(metrics) == 2 and all(np.isfinite(m["loss"]) for m in metrics)
    nc = 2 if folders else SMALL_VIT["num_classes"]
    like = jax.eval_shape(lambda: JV.init_params(
        jax.random.PRNGKey(0), JV.ViTConfig(**{**SMALL_VIT,
                                               "num_classes": nc})))
    params = j_load_npz(save, like)
    assert params["head"]["weight"].shape == (64, nc)
    assert params["blocks"]["attn"]["q"]["weight"].shape == (2, 64, 64)
