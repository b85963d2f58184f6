"""The JAX package's param trees -> the port's state_dicts (Mask R-CNN and
Faster R-CNN FPN and C4, RetinaNet, YOLACT, Pose2Seg, YOLOv3, ViT), and
back for YOLOv3 and ViT (the trees their training CLIs write as npz).

The inverses of ``tpuseg/weights/detectron_map.py::from_torch_state``,
``tpuseg/models/maskrcnn_c4.py::from_torch_state``,
``tpuseg/models/retinanet.py::from_torch_state``,
``tpuseg/weights/yolact_map.py::from_torch_state`` and
``tpuseg/engine/pose2seg_engine.py::pose2seg_from_torch``: conv kernels HWIO ->
OIHW, linear weights [in, out] -> [out, in], fc6's rows back from the NHWC
(H, W, C) flattening to upstream's (C, H, W), and the deconv kernel
[kh, kw, in, out] -> [in, out, kh, kw]. Takes numpy arrays (``np.asarray``
of the JAX leaves, or ``weights/npz_io.py::load_params_npz``'s tree), so
this module needs no jax.
"""
from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.weights.npz_io import flatten_params, unflatten_params


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


def yolov3_state_dict_from_jax(params: dict) -> dict:
    """The JAX YOLOv3 tree (``yolov3.init_params`` /
    ``load_yolov3_weights``) -> the port's
    :class:`~tpuseg_torch.models.yolov3.YoloV3` state_dict. The port's
    modules carry the tree's paths as their names, so each leaf keeps its
    dotted path; conv kernels go HWIO -> OIHW, and each BatchNorm gets its
    step counter."""
    sd = {}
    for k, v in flatten_params(params).items():
        sd[k] = _t(v.transpose(3, 2, 0, 1) if v.ndim == 4 else v)
        if k.endswith(".bn.running_var"):
            sd[k.removesuffix("running_var") + "num_batches_tracked"] = (
                torch.tensor(0))
    return sd


def yolov3_jax_from_state_dict(sd: dict) -> dict:
    """The inverse of :func:`yolov3_state_dict_from_jax`: the tree the JAX
    package's ``save_params_npz`` writes for YOLOv3 (numpy f32 leaves)."""
    flat = {}
    for k, v in sd.items():
        if k.endswith("num_batches_tracked"):
            continue
        a = v.detach().cpu().float().numpy()
        flat[k] = np.ascontiguousarray(a.transpose(2, 3, 1, 0)
                                       if a.ndim == 4 else a)
    return unflatten_params(flat)


# the JAX ViT's stacked block leaves -> the port's (jeonsworld's) names
_VIT_BLOCK = {
    "ln1": "attention_norm", "ln2": "ffn_norm", "attn.q": "attn.query",
    "attn.k": "attn.key", "attn.v": "attn.value", "attn.out": "attn.out",
    "mlp.fc1": "ffn.fc1", "mlp.fc2": "ffn.fc2"}
_VIT_TOP = {
    "cls_token": "transformer.embeddings.cls_token",
    "pos_embed": "transformer.embeddings.position_embeddings",
    "ln.weight": "transformer.encoder.encoder_norm.weight",
    "ln.bias": "transformer.encoder.encoder_norm.bias",
    "head.bias": "head.bias"}
_VIT_LAYER = "transformer.encoder.layer.{}."


def vit_state_dict_from_jax(params: dict) -> dict:
    """The JAX ViT tree (``vit.init_params``, its blocks stacked on a
    leading layer axis) -> the port's
    :class:`~tpuseg_torch.nn.vit.VisionTransformer` state_dict: the layer
    axis unstacked, linear weights [in, out] -> [out, in], the patch
    embedding HWIO -> OIHW."""
    flat = flatten_params(params)
    sd = {dst: _t(flat[src]) for src, dst in _VIT_TOP.items()}
    sd["head.weight"] = _t(flat["head.weight"].T)
    sd["transformer.embeddings.patch_embeddings.weight"] = _t(
        flat["patch_embed.weight"].transpose(3, 2, 0, 1))
    sd["transformer.embeddings.patch_embeddings.bias"] = _t(
        flat["patch_embed.bias"])
    for src, dst in _VIT_BLOCK.items():
        w, b = flat[f"blocks.{src}.weight"], flat[f"blocks.{src}.bias"]
        for i in range(w.shape[0]):
            pre = _VIT_LAYER.format(i) + dst
            sd[f"{pre}.weight"] = _t(w[i].T if w.ndim == 3 else w[i])
            sd[f"{pre}.bias"] = _t(b[i])
    return sd


def vit_jax_from_state_dict(sd: dict) -> dict:
    """The inverse of :func:`vit_state_dict_from_jax`: the tree the JAX
    package's ``save_params_npz`` writes for ViT (numpy f32 leaves)."""
    def g(k):
        return sd[k].detach().cpu().float().numpy()

    nl = 1 + max(int(k.split(".")[3]) for k in sd
                 if k.startswith(_VIT_LAYER[:-3]))
    flat = {src: g(dst) for src, dst in _VIT_TOP.items()}
    flat["head.weight"] = g("head.weight").T
    flat["patch_embed.weight"] = g(
        "transformer.embeddings.patch_embeddings.weight").transpose(2, 3, 1, 0)
    flat["patch_embed.bias"] = g("transformer.embeddings.patch_embeddings.bias")
    for src, dst in _VIT_BLOCK.items():
        ws = [g(_VIT_LAYER.format(i) + dst + ".weight") for i in range(nl)]
        flat[f"blocks.{src}.weight"] = np.stack(
            [w.T if w.ndim == 2 else w for w in ws])
        flat[f"blocks.{src}.bias"] = np.stack(
            [g(_VIT_LAYER.format(i) + dst + ".bias") for i in range(nl)])
    return unflatten_params({k: np.ascontiguousarray(v)
                             for k, v in flat.items()})
