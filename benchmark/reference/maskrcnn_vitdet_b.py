"""The plain reference of ViTDet-B Mask R-CNN (detectron2's
``mask_rcnn_vitdet_b_100ep``): its R-CNN config and backbone sizes from the
configuration file, the model from a state dict, and the class layer's
calibration of the benchmark's random weights, for every kind of cell
(``maskrcnn_vitdet_b.<window>.py`` holds each kind's reference); float32
with TF32 off, through ``frozen/vitdet.py`` and ``frozen/maskrcnn_infer.py``.
It imports nothing of the port."""
from __future__ import annotations

import torch

from .exact import float32_exact
from .frozen import maskrcnn as M
from .frozen import maskrcnn_infer as I
from .frozen import vitdet as V



def config_fields(sizes: dict) -> dict:
    """The R-CNN config's fields (``frozen/maskrcnn.py::MaskRCNNConfig``)
    from the file: detectron2's test settings, 80 classes and the
    background (the port's class 0); the pooler's sampling ratio stays the
    port's 2 (the file states detectron2's ROIAlignV2)."""
    return dict(
        anchor_sizes=tuple(sizes["anchor_sizes"]),
        anchor_ratios=tuple(sizes["anchor_ratios"]),
        anchor_stride=tuple(sizes["anchor_stride"]),
        rpn_pre_nms_top_n=sizes["rpn_pre_nms_topk_test"],
        rpn_post_nms_top_n=sizes["rpn_post_nms_topk_test"],
        fpn_post_nms_top_n=sizes["rpn_post_nms_topk_test"],
        rpn_nms_thresh=sizes["rpn_nms_thresh"],
        num_classes=sizes["num_classes"] + 1,
        pooler_resolution=sizes["pooler_resolution"],
        score_thresh=sizes["score_thresh_test"],
        nms_thresh=sizes["nms_thresh_test"],
        detections_per_img=sizes["detections_per_image"],
        box_reg_weights=tuple(sizes["box_reg_weights"]),
        mask_resolution=sizes["mask_pooler_resolution"],
        mask_out=sizes["mask_resolution"],
        fpn_channels=sizes["out_channels"])


def vit_fields(sizes: dict) -> dict:
    """The backbone's and heads' sizes from the file."""
    return dict(
        img_size=sizes["img_size"], patch_size=sizes["patch_size"],
        embed_dim=sizes["embed_dim"], depth=sizes["depth"],
        num_heads=sizes["num_heads"], mlp_ratio=sizes["mlp_ratio"],
        window_size=sizes["window_size"],
        window_block_indexes=tuple(sizes["window_block_indexes"]),
        pretrain_img_size=sizes["pretrain_img_size"],
        ln_eps=sizes["ln_eps"], scale_factors=tuple(sizes["scale_factors"]),
        box_fc_dim=sizes["box_head_fc_dims"][0])


def model_config(sizes: dict) -> M.MaskRCNNConfig:
    return M.MaskRCNNConfig(**config_fields(sizes))


def rgb_norm(sizes: dict) -> tuple:
    return tuple(sizes["pixel_mean"]), tuple(sizes["pixel_std"])


def build(sizes: dict, state: dict, dev) -> V.ViTDetMaskRCNN:
    model = V.build_model(model_config(sizes), vit_fields(sizes))
    model.load_state_dict(state, strict=True)
    return model.to(dev).eval()


def class_calibration(sizes: dict, state: dict, frames, dev) -> tuple:
    """(scale, bias) of the class layer from ``frames`` (uint8 RGB), as
    ``maskrcnn_infer.class_calibration`` sets them."""
    with float32_exact(), torch.no_grad():
        model = build(sizes, state, dev)
        logits = []
        for img in frames:
            x, hw = I.canvas(img, sizes["min_size_test"],
                             sizes["max_size_test"], rgb_norm(sizes))
            logits.append(I.class_logits(model, torch.from_numpy(x).to(dev),
                                         hw))
        bias = model.roi_heads.box.predictor.cls_score.bias
        del model
    return I.class_calibration(logits, bias, sizes["score_thresh_test"])
