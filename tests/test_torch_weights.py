"""Weight maps of tpuseg_torch, the rule that it imports neither jax nor
the JAX package, and its entry points' default device."""
import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_cross_parity import NC, _synth_state
from tpuseg.models.maskrcnn import MaskRCNNConfig as JConfig
from tpuseg.weights.detectron_map import from_torch_state
from tpuseg_torch.models import maskrcnn as M
from tpuseg_torch.weights.detectron_map import load_detectron_weights
from tpuseg_torch.weights.from_jax import state_dict_from_jax

SLICE_MODULES = [
    "tpuseg_torch", "tpuseg_torch.kernels", "tpuseg_torch.kernels.nms",
    "tpuseg_torch.kernels.roi_align", "tpuseg_torch.core.boxes",
    "tpuseg_torch.nn.layers", "tpuseg_torch.nn.resnet", "tpuseg_torch.nn.fpn",
    "tpuseg_torch.ops.nms", "tpuseg_torch.ops.sampling",
    "tpuseg_torch.ops.preprocess", "tpuseg_torch.models.maskrcnn",
    "tpuseg_torch.weights.detectron_map", "tpuseg_torch.weights.from_jax",
    "tpuseg_torch.engine.maskrcnn_engine", "tpuseg_torch.engine.predictor",
    "tpuseg_torch.tools.maskrcnn_infer", "tpuseg_torch.data.image_io",
    "tpuseg_torch.models.maskrcnn_loss", "tpuseg_torch.engine.trainer",
    "tpuseg_torch.engine.detectron_train_loop", "tpuseg_torch.kernels.dcn",
    "tpuseg_torch.ops.deform_conv", "tpuseg_torch.models.yolact",
    "tpuseg_torch.configs.presets", "tpuseg_torch.weights.yolact_map",
    "tpuseg_torch.engine.yolact_engine", "tpuseg_torch.tools.yolact_infer",
    "tpuseg_torch.models.yolact_loss", "tpuseg_torch.data.augment",
    "tpuseg_torch.engine.yolact_train_loop", "tpuseg_torch.eval.rle",
    "tpuseg_torch.eval.coco", "tpuseg_torch.eval.cocoeval",
    "tpuseg_torch.eval.yolact_map", "tpuseg_torch.data.coco_dataset",
    "tpuseg_torch.data.catalog", "tpuseg_torch.data.native_loader",
    "tpuseg_torch.data.prefetch", "tpuseg_torch.engine.config",
    "tpuseg_torch.tools.test_net", "tpuseg_torch.tools.train_net",
    "tpuseg_torch.tools.yolact_eval", "tpuseg_torch.tools.yolact_train",
    "tpuseg_torch.models.maskrcnn_c4", "tpuseg_torch.models.retinanet",
    "tpuseg_torch.ops.losses", "tpuseg_torch.models.pose2seg",
    "tpuseg_torch.models.pose2seg_loss", "tpuseg_torch.weights.pose2seg_map",
    "tpuseg_torch.engine.pose2seg_engine", "tpuseg_torch.tools.pose2seg_test",
    "tpuseg_torch.tools.pose2seg_train", "tpuseg_torch.nn.darknet",
    "tpuseg_torch.models.yolov3", "tpuseg_torch.models.yolov3_loss",
    "tpuseg_torch.weights.darknet_io", "tpuseg_torch.weights.npz_io",
    "tpuseg_torch.engine.yolo_engine", "tpuseg_torch.tools.yolo_detect",
    "tpuseg_torch.tools.yolo_eval", "tpuseg_torch.tools.yolo_train",
    "tpuseg_torch.nn.vit", "tpuseg_torch.weights.vit_map",
    "tpuseg_torch.engine.classify", "tpuseg_torch.engine.vit_train",
    "tpuseg_torch.tools.vit_infer", "tpuseg_torch.tools.vit_train",
    "tpuseg_torch.tools.parity_gate",
]
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def synth():
    return _synth_state(np.random.default_rng(3))


def test_jax_params_round_trip_to_state_dict(synth):
    cfg = M.MaskRCNNConfig(num_classes=NC)
    sd = state_dict_from_jax(from_torch_state(synth, JConfig(num_classes=NC)),
                             cfg)
    assert sd.keys() == synth.keys()
    for k, v in synth.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)
    M.build_model(cfg).load_state_dict(sd, strict=True)


def test_load_detectron_checkpoint_quirks(synth, tmp_path):
    """A checkpoint as upstream saves it: nested under "model", keys with
    "module.", the anchor generator's buffers, and FrozenBN layers without
    mean/var (folded Caffe2 conversions) -> loads strict, stats 0 / 1."""
    sd = {f"module.{k}": torch.from_numpy(v) for k, v in synth.items()
          if k not in ("backbone.body.stem.bn1.running_mean",
                       "backbone.body.stem.bn1.running_var")}
    sd["module.rpn.anchor_generator.cell_anchors.0"] = torch.zeros(3, 4)
    path = tmp_path / "ckpt.pth"
    torch.save({"model": sd, "iteration": 90000}, path)
    model = load_detectron_weights(str(path), M.build_model(
        M.MaskRCNNConfig(num_classes=NC)))
    bn = model.backbone.body.stem.bn1
    assert not bn.running_mean.any() and (bn.running_var == 1).all()
    np.testing.assert_array_equal(
        model.roi_heads.box.feature_extractor.fc6.weight.detach().numpy(),
        synth["roi_heads.box.feature_extractor.fc6.weight"])


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')))\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _imported_modules(path: Path):
    """Every module an ``import`` or ``from ... import`` names, at any
    depth of the file (inside functions too)."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _path_strings(path: Path):
    """String constants that could name the JAX package's native loader:
    a ``..`` path part (a walk up out of the port) or its library's name."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and (
                ".." in node.value.replace("\\", "/").split("/")
                or "libtpuseg_loader" in node.value):
            yield node.value


def test_port_and_smoke_import_nothing_of_jax_or_the_jax_package():
    """Nor cv2: the port runs where OpenCV is not installed. Nor does it
    reach the JAX package's native loader (``native/``) by a path: its
    loader builds from ``tpuseg_torch/native/``."""
    files = sorted((ROOT / "tpuseg_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for sub in ("eval", "data", "engine", "tools"):
        new = {f"{m.rsplit('.', 1)[1]}.py" for m in SLICE_MODULES
               if m.startswith(f"tpuseg_torch.{sub}.")}
        assert new <= {f.name for f in files
                       if f.parent.name == sub}, (sub, new)
    bad = [f"{f.relative_to(ROOT)}: {m}" for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("tpuseg", "jax", "jaxlib", "cv2", "native")]
    bad += [f"{f.relative_to(ROOT)}: {s!r}" for f in files
            for s in _path_strings(f)]
    assert not bad, bad
    from tpuseg_torch.data import native_loader

    assert native_loader.SOURCE.is_relative_to(ROOT / "tpuseg_torch")
    assert native_loader.BUILD_ROOT.is_relative_to(ROOT / "build")


def test_entry_points_default_to_the_card():
    """Every variant of the predictor (the detectron family: "fpn", "c4",
    "retinanet", "vitdet"), do_train for each model's config and the Pose2Seg
    predictor run on the card unless the caller asks for the CPU."""
    from tpuseg_torch.engine.detectron_train_loop import do_train
    from tpuseg_torch.engine.maskrcnn_engine import (VARIANTS,
                                                     MaskRCNNPredictor)
    from tpuseg_torch.engine.pose2seg_engine import Pose2SegPredictor
    from tpuseg_torch.engine.predictor import COCODemo
    from tpuseg_torch.engine.yolact_train_loop import train

    for fn in (MaskRCNNPredictor.__init__, COCODemo.__init__, do_train,
               train, Pose2SegPredictor.__init__):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert sorted(VARIANTS) == ["c4", "fpn", "retinanet", "vitdet"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            MaskRCNNPredictor(M.MaskRCNNConfig(num_classes=NC))
        for variant, (_, config) in VARIANTS.items():
            with pytest.raises(RuntimeError, match="CUDA"):
                MaskRCNNPredictor(variant=variant)
            with pytest.raises(RuntimeError, match="CUDA"):
                do_train(None, config(num_classes=NC))
        with pytest.raises(RuntimeError, match="CUDA"):
            train(None, None)
        with pytest.raises(RuntimeError, match="CUDA"):
            Pose2SegPredictor()
