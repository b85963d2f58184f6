"""The JAX package's param trees -> the port's state_dicts (Mask R-CNN and
Faster R-CNN FPN and C4, RetinaNet, YOLACT, Pose2Seg).

The inverses of ``tpuseg/weights/detectron_map.py::from_torch_state``,
``tpuseg/models/maskrcnn_c4.py::from_torch_state``,
``tpuseg/models/retinanet.py::from_torch_state``,
``tpuseg/weights/yolact_map.py::from_torch_state`` and
``tpuseg/engine/pose2seg_engine.py::pose2seg_from_torch``: conv kernels HWIO ->
OIHW, linear weights [in, out] -> [out, in], fc6's rows back from the NHWC
(H, W, C) flattening to upstream's (C, H, W), and the deconv kernel
[kh, kw, in, out] -> [in, out, kh, kw]. Takes numpy arrays (``np.asarray``
of the JAX leaves), so this module needs no jax.
"""
from __future__ import annotations

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # a copy


def _conv(sd: dict, name: str, p: dict) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["weight"]).transpose(3, 2, 0, 1))
    if p.get("bias") is not None:
        sd[f"{name}.bias"] = _t(p["bias"])


def _bn(sd: dict, name: str, p: dict) -> None:
    for k in ("weight", "bias", "running_mean", "running_var"):
        sd[f"{name}.{k}"] = _t(p[k])


def _linear(sd: dict, name: str, p: dict, weight=None) -> None:
    w = np.asarray(p["weight"]) if weight is None else weight
    sd[f"{name}.weight"] = _t(w.T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _stage(sd: dict, prefix: str, blocks: list, bn=_bn) -> None:
    """A ResNet stage's bottlenecks under ``prefix``; ``bn`` writes each
    norm (FrozenBN's four tensors, or BatchNorm2d's with its counter)."""
    for bi, blk in enumerate(blocks):
        base = f"{prefix}.{bi}"
        for i in (1, 2, 3):
            _conv(sd, f"{base}.conv{i}", blk[f"conv{i}"])
            bn(sd, f"{base}.bn{i}", blk[f"bn{i}"])
        if blk.get("downsample") is not None:
            _conv(sd, f"{base}.downsample.0", blk["downsample"]["conv"])
            bn(sd, f"{base}.downsample.1", blk["downsample"]["bn"])


def _body(sd: dict, bb: dict) -> None:
    """``backbone.body.*``: the stem and the stages the tree has."""
    body = "backbone.body."
    _conv(sd, body + "stem.conv1", bb["stem"]["conv"])
    _bn(sd, body + "stem.bn1", bb["stem"]["bn"])
    for si in range(4):
        if f"layer{si + 1}" in bb:
            _stage(sd, f"{body}layer{si + 1}", bb[f"layer{si + 1}"])


def _rpn(sd: dict, rpn: dict) -> None:
    for src, dst in (("conv", "conv"), ("cls", "cls_logits"),
                     ("bbox", "bbox_pred")):
        _conv(sd, f"rpn.head.{dst}", rpn[src])


def _mask_predictor(sd: dict, mp: dict) -> None:
    """The deconv [kh, kw, in, out] -> [in, out, kh, kw] and the 1x1."""
    sd["roi_heads.mask.predictor.conv5_mask.weight"] = _t(
        np.asarray(mp["conv5_mask"]["weight"]).transpose(2, 3, 0, 1))
    sd["roi_heads.mask.predictor.conv5_mask.bias"] = _t(
        mp["conv5_mask"]["bias"])
    _conv(sd, "roi_heads.mask.predictor.mask_fcn_logits",
          mp["mask_fcn_logits"])


def state_dict_from_jax(params: dict, cfg) -> dict:
    """``params``: the tree ``from_torch_state``/``init_params`` returns;
    ``cfg``: the port's (or the JAX) ``MaskRCNNConfig``. A tree without
    ``mask_head`` (Faster R-CNN) gives no ``roi_heads.mask.*``."""
    sd = {}
    _body(sd, params["backbone"])
    for i in range(4):
        _conv(sd, f"backbone.fpn.fpn_inner{i + 1}", params["fpn"]["inner"][i])
        _conv(sd, f"backbone.fpn.fpn_layer{i + 1}", params["fpn"]["layer"][i])
    _rpn(sd, params["rpn"])
    bh = params["box_head"]
    c, r = cfg.fpn_channels, cfg.pooler_resolution
    fc6 = np.asarray(bh["fc6"]["weight"]).reshape(r, r, c, -1)
    fc6 = fc6.transpose(2, 0, 1, 3).reshape(c * r * r, -1)  # rows (C, H, W)
    _linear(sd, "roi_heads.box.feature_extractor.fc6", bh["fc6"], weight=fc6)
    _linear(sd, "roi_heads.box.feature_extractor.fc7", bh["fc7"])
    _linear(sd, "roi_heads.box.predictor.cls_score", bh["cls_score"])
    _linear(sd, "roi_heads.box.predictor.bbox_pred", bh["bbox_pred"])
    if "mask_head" in params:
        mh = params["mask_head"]
        for i in range(1, 5):
            _conv(sd, f"roi_heads.mask.feature_extractor.mask_fcn{i}",
                  mh[f"mask_fcn{i}"])
        _mask_predictor(sd, mh)
    return sd


def c4_state_dict_from_jax(params: dict) -> dict:
    """The JAX C4 tree (``maskrcnn_c4.init_params`` / ``from_torch_state``)
    -> the port's :class:`~tpuseg_torch.models.maskrcnn_c4.MaskRCNNC4`
    state_dict; a tree without ``mask_pred`` (Faster R-CNN C4) gives no
    ``roi_heads.mask.*``."""
    sd = {}
    _body(sd, params["backbone"])
    _stage(sd, "roi_heads.box.feature_extractor.head.layer4",
           params["roi_head"]["layer4"])
    _rpn(sd, params["rpn"])
    _linear(sd, "roi_heads.box.predictor.cls_score",
            params["box_pred"]["cls_score"])
    _linear(sd, "roi_heads.box.predictor.bbox_pred",
            params["box_pred"]["bbox_pred"])
    if "mask_pred" in params:
        _mask_predictor(sd, params["mask_pred"])
    return sd


def retinanet_state_dict_from_jax(params: dict) -> dict:
    """The JAX RetinaNet tree (``retinanet.init_params`` /
    ``from_torch_state``) -> the port's
    :class:`~tpuseg_torch.models.retinanet.RetinaNet` state_dict."""
    sd = {}
    _body(sd, params["backbone"])
    fpn = params["fpn"]
    for i in range(3):
        _conv(sd, f"backbone.fpn.fpn_inner{i + 2}", fpn["inner"][i])
        _conv(sd, f"backbone.fpn.fpn_layer{i + 2}", fpn["layer"][i])
    _conv(sd, "backbone.fpn.top_blocks.p6", fpn["p6"])
    _conv(sd, "backbone.fpn.top_blocks.p7", fpn["p7"])
    for tower in ("cls_tower", "bbox_tower"):
        for i, conv in enumerate(params[tower]):
            _conv(sd, f"rpn.head.{tower}.{2 * i}", conv)
    _conv(sd, "rpn.head.cls_logits", params["cls_logits"])
    _conv(sd, "rpn.head.bbox_pred", params["bbox_pred"])
    return sd


def _bn_tracked(sd: dict, name: str, p: dict) -> None:
    """BatchNorm2d's tensors, with the step counter it carries."""
    _bn(sd, name, p)
    sd[f"{name}.num_batches_tracked"] = torch.tensor(0)


def yolact_state_dict_from_jax(params: dict, cfg) -> dict:
    """The JAX package's YOLACT param tree (``init_params`` /
    ``yolact_map.from_torch_state``; numpy leaves) -> the port's
    :class:`~tpuseg_torch.models.yolact.Yolact` state_dict, the keys of
    ``tpuseg/weights/yolact_map.py::to_torch_state``. ``cfg``: the port's
    or the JAX ``YolactConfig``."""
    if not cfg.backbone.startswith("resnet"):
        raise NotImplementedError(f"backbone {cfg.backbone}: not ported yet")
    sd = {}
    bb = params["backbone"]
    _conv(sd, "backbone.conv1", bb["stem"]["conv"])
    _bn_tracked(sd, "backbone.bn1", bb["stem"]["bn"])
    for si in range(4):
        for bi, blk in enumerate(bb[f"layer{si + 1}"]):
            base = f"backbone.layers.{si}.{bi}"
            for i in (1, 2, 3):
                _conv(sd, f"{base}.conv{i}", blk[f"conv{i}"])
                _bn_tracked(sd, f"{base}.bn{i}", blk[f"bn{i}"])
            if blk.get("conv2_offset") is not None:
                _conv(sd, f"{base}.conv2.conv_offset_mask",
                      blk["conv2_offset"])
            if blk.get("downsample") is not None:
                _conv(sd, f"{base}.downsample.0", blk["downsample"]["conv"])
                _bn_tracked(sd, f"{base}.downsample.1",
                            blk["downsample"]["bn"])
    fpn = params["fpn"]
    for i in range(3):
        _conv(sd, f"fpn.lat_layers.{i}", fpn["lat"][i])
        # the JAX tree applies pred[j] to P_{3+j}; pred_layers.0 is P5's
        _conv(sd, f"fpn.pred_layers.{i}", fpn["pred"][2 - i])
    for i in range(2):
        _conv(sd, f"fpn.downsample_layers.{i}", fpn["down"][i])
    for ci, idx in enumerate((0, 2, 4, 8, 10)):
        _conv(sd, f"proto_net.{idx}", params["proto"][f"conv{ci}"])
    head = "prediction_layers.0."
    _conv(sd, head + "upfeature.0", params["pred"]["upfeature"])
    for src, dst in (("bbox", "bbox_layer"), ("conf", "conf_layer"),
                     ("mask", "mask_layer")):
        _conv(sd, head + dst, params["pred"][src])
    if "semantic" in params:
        _conv(sd, "semantic_seg_conv", params["semantic"])
    if "maskiou" in params:
        for i in range(5):
            _conv(sd, f"maskiou_net.maskiou_net.{2 * i}",
                  params["maskiou"][f"conv{i}"])
        _conv(sd, "maskiou_net.maskiou_net.10", params["maskiou"]["conv_last"])
    return sd


def pose2seg_state_dict_from_jax(params: dict) -> dict:
    """The JAX package's Pose2Seg tree (``pose2seg.init_params`` /
    ``pose2seg_from_torch``; numpy leaves, any widths) -> the port's
    :class:`~tpuseg_torch.models.pose2seg.Pose2Seg` state_dict, upstream's
    keys: ``backbone.{conv1,bn1,layer1-4,toplayer,latlayer1-3,
    smooth1-3}.*``, ``segnet.{conv1,bn1,layers.i,conv2}.*``."""
    sd = {}
    bb = params["backbone"]
    _conv(sd, "backbone.conv1", bb["stem"]["conv"])
    _bn_tracked(sd, "backbone.bn1", bb["stem"]["bn"])
    for si in range(4):
        _stage(sd, f"backbone.layer{si + 1}", bb[f"layer{si + 1}"],
               bn=_bn_tracked)
    for name, p in params["fpn"].items():
        _conv(sd, f"backbone.{name}", p)
    seg = params["seg"]
    _conv(sd, "segnet.conv1", seg["conv1"])
    _bn_tracked(sd, "segnet.bn1", seg["bn1"])
    _stage(sd, "segnet.layers", seg["units"], bn=_bn_tracked)
    _conv(sd, "segnet.conv2", seg["classifier"])
    return sd
