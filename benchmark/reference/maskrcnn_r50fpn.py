"""The plain reference of Mask R-CNN R-50-FPN (maskrcnn-benchmark's
e2e_mask_rcnn_R_50_FPN_1x): its model config from the configuration's
sizes, for every kind of cell (``maskrcnn_r50fpn.<window>.py`` holds each
kind's reference). It imports nothing of the port."""
from __future__ import annotations

from .frozen import maskrcnn as M


def config_fields(sizes: dict) -> dict:
    """The model config's fields from the configuration file's sizes."""
    return dict(
        depth=sizes["depth"], freeze_at=sizes["freeze_conv_body_at"],
        anchor_sizes=tuple(sizes["anchor_sizes"]),
        anchor_ratios=tuple(sizes["anchor_ratios"]),
        anchor_stride=tuple(sizes["anchor_stride"]),
        rpn_pre_nms_top_n=sizes["rpn_pre_nms_top_n_test"],
        rpn_post_nms_top_n=sizes["fpn_post_nms_top_n_test"],
        fpn_post_nms_top_n=sizes["fpn_post_nms_top_n_test"],
        rpn_nms_thresh=sizes["rpn_nms_thresh"],
        rpn_pre_nms_top_n_train=sizes["rpn_pre_nms_top_n_train"],
        fpn_post_nms_top_n_train=sizes["fpn_post_nms_top_n_train"],
        num_classes=sizes["num_classes"],
        pooler_resolution=sizes["pooler_resolution"],
        pooler_sampling_ratio=sizes["pooler_sampling_ratio"],
        score_thresh=sizes["score_thresh"], nms_thresh=sizes["nms_thresh"],
        detections_per_img=sizes["detections_per_img"],
        mask_resolution=sizes["mask_pooler_resolution"],
        mask_out=sizes["mask_resolution"], fpn_channels=sizes["fpn_channels"])


def model_config(sizes: dict) -> M.MaskRCNNConfig:
    return M.MaskRCNNConfig(**config_fields(sizes))
