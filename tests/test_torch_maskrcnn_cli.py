"""The Mask R-CNN CLIs of the port, test_net and train_net, through their
main() with --device=cpu on the five-image dataset of
test_torch_eval_engines.py at a 48x64 canvas (the RPN budgets cut by the
test's options), from the smoke's synthetic weights; train_net also in
bf16 mixed precision, its checkpoint read by tpuseg."""
import numpy as np
import pytest
import torch

from tests.test_torch_eval_engines import ROOT, coco  # noqa: F401
from tests.test_torch_npz_io import assert_trees_equal
from tpuseg.engine.trainer import load_params_npz as j_load_npz
from tpuseg.models import maskrcnn as JM
from tpuseg.weights import detectron_map as JDM
from tpuseg_torch.tools import test_net, train_net

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores


MASKRCNN_OPTS = ["MODEL.RPN.PRE_NMS_TOP_N_TEST", "64",
                 "MODEL.RPN.POST_NMS_TOP_N_TEST", "32",
                 "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "32",
                 "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "32"]


@pytest.fixture(scope="module")
def maskrcnn_ckpt(tmp_path_factory):
    """The smoke's synthetic upstream-keyed weights (class scores scaled so
    that detections pass 0.05), as a maskrcnn-benchmark checkpoint."""
    from chip_smoke import synthetic_state_dict
    from tpuseg_torch.models import maskrcnn as M

    path = tmp_path_factory.mktemp("w") / "e2e_mask_rcnn_R_50_FPN.pth"
    torch.save({"model": synthetic_state_dict(
        M.build_model(M.MaskRCNNConfig()), 0)}, path)
    return str(path)


def test_test_net_cli_on_cpu(coco, maskrcnn_ckpt, capsys):
    img_dir, ann = coco
    stats = test_net.main([
        "--config-file", str(ROOT / "configs/e2e_mask_rcnn_R_50_FPN_1x.yaml"),
        "--images", img_dir, "--annotations", ann, "--max_images", "4",
        "--batch_size", "2", "--device=cpu", "MODEL.WEIGHT", maskrcnn_ckpt,
        "INPUT.MIN_SIZE_TEST", "48", "INPUT.MAX_SIZE_TEST", "64",
        *MASKRCNN_OPTS])
    assert stats.keys() == {"bbox", "segm"}
    for s in stats.values():
        assert s.shape == (12,) and np.isfinite(s).all()
    assert "== segm ==" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        test_net.main(["--devices", "all", "--device=cpu"])


def test_train_net_cli_on_cpu(coco, maskrcnn_ckpt, tmp_path, capsys):
    img_dir, ann = coco
    history = train_net.main([
        "--max_steps", "1", "--device=cpu",
        "DATASETS.IMAGES", img_dir, "DATASETS.ANNOTATIONS", ann,
        "SOLVER.IMS_PER_BATCH", "1", "INPUT.MIN_SIZE_TRAIN", "48",
        "INPUT.MAX_SIZE_TRAIN", "64", "OUTPUT_DIR", str(tmp_path),
        "MODEL.WEIGHT", maskrcnn_ckpt, *MASKRCNN_OPTS])
    assert len(history) == 1
    assert all(np.isfinite(v) for v in history[0].values())
    assert "1 iterations; last losses: loss_rpn_box_reg" in (
        capsys.readouterr().out)
    # mixed precision, and the checkpoint in both formats: the npz is
    # tpuseg's tree of the model (its load_params_npz on its own template)
    history = train_net.main([
        "--max_steps", "1", "--compute_dtype", "bfloat16", "--device=cpu",
        "DATASETS.IMAGES", img_dir, "DATASETS.ANNOTATIONS", ann,
        "SOLVER.IMS_PER_BATCH", "1", "SOLVER.CHECKPOINT_PERIOD", "1",
        "INPUT.MIN_SIZE_TRAIN", "48", "INPUT.MAX_SIZE_TRAIN", "64",
        "OUTPUT_DIR", str(tmp_path), "MODEL.WEIGHT", maskrcnn_ckpt,
        *MASKRCNN_OPTS])
    assert len(history) == 1
    assert all(np.isfinite(v) for v in history[0].values())
    pth = torch.load(tmp_path / "model_0000001.pth", weights_only=True)
    like = JDM.from_torch_state(
        {k: v.numpy() for k, v in pth["model"].items()}, JM.MaskRCNNConfig())
    tree = j_load_npz(str(tmp_path / "model_0000001.npz"), like)
    assert_trees_equal(tree, like)
    assert all(v.dtype == torch.float32 for v in pth["model"].values())
