"""Every yaml in configs/ builds a predictor and a training run in
tpuseg_torch: build_predictor_from_cfg and do_train with --device=cpu on
the five-image dataset of test_torch_eval_engines.py at a 48x64 canvas
(random weights from the predictor's seed; the RPN budgets, the
detections and C4's RoI sample cut by the test). The dispatch itself is
held against tpuseg's in test_torch_eval_engines.py."""
import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_eval_engines import ROOT, coco  # noqa: F401
from tpuseg_torch.data.coco_dataset import (COCO_LABEL_MAP,
                                            CocoDetectionDataset)
from tpuseg_torch.engine import maskrcnn_engine as ME
from tpuseg_torch.engine.config import ConfigNode
from tpuseg_torch.engine.detectron_train_loop import do_train
from tpuseg_torch.models import maskrcnn_loss as ML

torch.set_num_threads(2)  # pytest-xdist's workers share the CPU's cores

OPTS = ["INPUT.MIN_SIZE_TEST", "48", "INPUT.MAX_SIZE_TEST", "64",
        "MODEL.RPN.PRE_NMS_TOP_N_TEST", "64",
        "MODEL.RPN.POST_NMS_TOP_N_TEST", "32",
        "MODEL.RPN.FPN_POST_NMS_TOP_N_TEST", "32",
        "MODEL.RPN.PRE_NMS_TOP_N_TRAIN", "64",
        "MODEL.RPN.POST_NMS_TOP_N_TRAIN", "32",
        "MODEL.RPN.FPN_POST_NMS_TOP_N_TRAIN", "32"]


@pytest.fixture
def small(monkeypatch):
    """10 detections an image (C4's mask head runs res5 on each) and 16
    sampled RoIs an image in training."""
    real_cfg, real_loss = ME.model_config_from_node, ML.MaskRCNNLossConfig

    def cfg(node):
        variant, c = real_cfg(node)
        return variant, dataclasses.replace(c, detections_per_img=10)

    monkeypatch.setattr(ME, "model_config_from_node", cfg)
    monkeypatch.setattr(ML, "MaskRCNNLossConfig", lambda **kw: real_loss(
        **{"roi_batch_per_image": 16, **kw}))


@pytest.mark.parametrize("yaml_file", sorted(
    p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_every_yaml_builds_a_predictor_and_a_training_run(coco, small,
                                                          tmp_path,
                                                          yaml_file):
    img_dir, ann = coco
    node = ConfigNode({"MODEL": {"WEIGHT": ""}})
    node.merge_from_file(str(ROOT / "configs" / yaml_file))
    node.merge_from_list(OPTS)
    variant, cfg = ME.model_config_from_node(node)
    pred = ME.build_predictor_from_cfg(node, device="cpu")
    assert pred.variant == variant and pred.cfg == cfg
    mask_on = getattr(cfg, "mask_on", False)
    dataset = CocoDetectionDataset(img_dir, ann, label_map=COCO_LABEL_MAP)
    img = dataset.load_image(dataset.image_ids[0])[:, :, ::-1]
    res = pred.run_on_bgr_image(np.ascontiguousarray(img))
    n = len(res["scores"])
    assert res["boxes"].shape == (n, 4) and ("masks" in res) == mask_on
    assert np.isfinite(res["boxes"]).all() and n <= 10
    _, it, history = do_train(dataset, cfg, model=pred.model, max_steps=1,
                              ims_per_batch=1, device="cpu", min_size=48,
                              max_size=64, output_dir=str(tmp_path))
    assert it == 1 and all(np.isfinite(v) for v in history[0].values())
    assert ("loss_mask" in history[0]) == mask_on
