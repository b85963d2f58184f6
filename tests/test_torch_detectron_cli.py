"""test_net and train_net of the port with the C4 and RetinaNet yamls
(e2e_mask_rcnn_R_50_C4_1x, e2e_faster_rcnn_R_50_C4_1x and
retinanet_R_50_FPN_1x), through their main() with --device=cpu on the
five-image dataset of test_torch_eval_engines.py at a 48x64 canvas (the RPN
budgets cut by the test's options, and C4's RoI sample by the test), from
the smoke's synthetic upstream-keyed weights."""
import numpy as np
import pytest
import torch

from tests.test_torch_eval_engines import ROOT, coco  # noqa: F401
from tpuseg_torch.models import maskrcnn_c4 as C4
from tpuseg_torch.models import maskrcnn_loss as ML
from tpuseg_torch.models import retinanet as RN
from tpuseg_torch.tools import test_net, train_net

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

SMALL = ["INPUT.MIN_SIZE_TEST", "48", "INPUT.MAX_SIZE_TEST", "64",
         "INPUT.MIN_SIZE_TRAIN", "48", "INPUT.MAX_SIZE_TRAIN", "64"]
C4_OPTS = ["MODEL.RPN.PRE_NMS_TOP_N_TEST", "64",
           "MODEL.RPN.POST_NMS_TOP_N_TEST", "32",
           "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "64",
           "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "32"]
YAMLS = {"c4": "e2e_mask_rcnn_R_50_C4_1x.yaml",
         "faster_c4": "e2e_faster_rcnn_R_50_C4_1x.yaml",
         "retinanet": "retinanet_R_50_FPN_1x.yaml"}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """The smoke's synthetic weights of the three models, as
    maskrcnn-benchmark checkpoints."""
    from chip_smoke import synthetic_state_dict

    root = tmp_path_factory.mktemp("w")
    out = {}
    for name, model in (
            ("c4", C4.build_model(C4.MaskRCNNC4Config())),
            ("faster_c4", C4.build_model(C4.MaskRCNNC4Config(mask_on=False))),
            ("retinanet", RN.build_model(RN.RetinaNetConfig()))):
        out[name] = str(root / f"{name}.pth")
        torch.save({"model": synthetic_state_dict(model, 0)}, out[name])
    return out


@pytest.fixture
def small_roi_sample(monkeypatch):
    """C4's res5 runs on every sampled RoI slot (512 an image by default):
    16 keep a CPU step in seconds."""
    real = ML.MaskRCNNLossConfig

    def cfg(**kw):
        return real(**{"roi_batch_per_image": 16, **kw})

    monkeypatch.setattr(C4.ML, "MaskRCNNLossConfig", cfg)


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_test_net_cli_on_cpu(coco, ckpts, capsys, name):
    img_dir, ann = coco
    stats = test_net.main([
        "--config-file", str(ROOT / "configs" / YAMLS[name]),
        "--images", img_dir, "--annotations", ann, "--max_images", "4",
        "--batch_size", "2", "--device=cpu", "MODEL.WEIGHT", ckpts[name],
        *SMALL, *(C4_OPTS if name != "retinanet" else [])])
    want = {"bbox", "segm"} if name == "c4" else {"bbox"}
    assert stats.keys() == want
    for s in stats.values():
        assert s.shape == (12,) and np.isfinite(s).all()
    out = capsys.readouterr().out
    assert "== bbox ==" in out and ("== segm ==" in out) == (name == "c4")


@pytest.mark.parametrize("name", sorted(YAMLS))
def test_train_net_cli_on_cpu(coco, ckpts, tmp_path, capsys,
                              small_roi_sample, name):
    img_dir, ann = coco
    history = train_net.main([
        "--config-file", str(ROOT / "configs" / YAMLS[name]),
        "--max_steps", "1", "--device=cpu",
        "DATASETS.IMAGES", img_dir, "DATASETS.ANNOTATIONS", ann,
        "SOLVER.IMS_PER_BATCH", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
        "OUTPUT_DIR", str(tmp_path), "MODEL.WEIGHT", ckpts[name], *SMALL,
        *(C4_OPTS if name != "retinanet" else [])])
    assert len(history) == 1
    keys = {"c4": {"loss_mask"}, "faster_c4": set(),
            "retinanet": {"loss_retina_cls", "loss_retina_reg"}}[name]
    assert keys <= set(history[0]) and "total" in history[0]
    assert ("loss_mask" in history[0]) == (name == "c4")
    assert all(np.isfinite(v) for v in history[0].values())
    assert "1 iterations; last losses" in capsys.readouterr().out
    saved = torch.load(tmp_path / "model_0000001.pth", weights_only=True)
    assert saved["iteration"] == 1
    assert saved["model"].keys() == torch.load(
        ckpts[name], weights_only=True)["model"].keys()
