"""The JAX package's param trees <-> the port's state_dicts: Mask R-CNN
and Faster R-CNN FPN and C4, RetinaNet, YOLACT (ResNet and DarkNet-53),
Pose2Seg, YOLOv3 and ViT, both ways (``*_state_dict_from_jax`` and the
inverse ``*_jax_from_state_dict``, the tree the JAX package's
``save_params_npz`` writes).

The JAX side is the inverse of ``tpuseg/weights/detectron_map.py::
from_torch_state``, ``tpuseg/models/maskrcnn_c4.py::from_torch_state``,
``tpuseg/models/retinanet.py::from_torch_state``,
``tpuseg/weights/yolact_map.py::from_torch_state`` and
``tpuseg/engine/pose2seg_engine.py::pose2seg_from_torch``: conv kernels HWIO
<-> OIHW, linear weights [in, out] <-> [out, in], fc6's rows from the NHWC
(H, W, C) flattening to upstream's (C, H, W), and the deconv kernel
[kh, kw, in, out] <-> [in, out, kh, kw]. Each family's layout is written
once, as a walk over a :class:`_Layout`, which reads it either way. Takes
numpy arrays (``np.asarray`` of the JAX leaves, or
``weights/npz_io.py::load_params_npz``'s tree), so this module needs no
jax.
"""
from __future__ import annotations

import numpy as np
import torch

from tpuseg_torch.weights.npz_io import flatten_params, unflatten_params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, order="C"))  # a copy


class _Layout:
    """One walk between a JAX tree and a state_dict, either way: given a
    ``tree`` it fills a state_dict, given a ``state_dict`` it fills the
    tree. Each step names the state_dict key and the tree's dotted path;
    :meth:`has` and :meth:`count` ask the side that is read."""

    def __init__(self, tree=None, state_dict=None):
        self.to_sd = tree is not None
        if self.to_sd:
            self.src = flatten_params(tree)
        else:
            self.src = {k: v.detach().cpu().float().numpy()
                        for k, v in state_dict.items()
                        if not k.endswith("num_batches_tracked")}
        self.prefixes = set()
        for k in self.src:
            parts = k.split(".")
            self.prefixes.update(".".join(parts[:i])
                                 for i in range(1, len(parts) + 1))
        self.out = {}

    def _name(self, key: str, path: str) -> str:
        return path if self.to_sd else key

    def has(self, key: str, path: str) -> bool:
        return self._name(key, path) in self.prefixes

    def count(self, key: str, path: str) -> int:
        """The items of the list at ``path`` (``key`` on the port's side)."""
        name = self._name(key, path) + "."
        idx = {k[len(name):].split(".")[0] for k in self.src
               if k.startswith(name)}
        return 1 + max((int(i) for i in idx if i.isdigit()), default=-1)

    def leaf(self, key: str, path: str, fwd=None, inv=None) -> None:
        """state_dict[key] = fwd(tree[path]), tree[path] = inv(sd[key])."""
        if self.to_sd:
            a = np.asarray(self.src[path])
            self.out[key] = _t(fwd(a) if fwd else a)
        else:
            a = self.src[key]
            self.out[path] = np.ascontiguousarray(inv(a) if inv else a)

    def counter(self, key: str) -> None:
        """BatchNorm2d's step counter (state_dict side only)."""
        if self.to_sd:
            self.out[key] = torch.tensor(0)

    def result(self):
        return self.out if self.to_sd else unflatten_params(self.out)


def _hwio(a):
    return a.transpose(3, 2, 0, 1)


def _oihw(a):
    return a.transpose(2, 3, 1, 0)


def _conv(m: _Layout, key: str, path: str) -> None:
    m.leaf(f"{key}.weight", f"{path}.weight", _hwio, _oihw)
    if m.has(f"{key}.bias", f"{path}.bias"):
        m.leaf(f"{key}.bias", f"{path}.bias")


def _bn(m: _Layout, key: str, path: str, tracked: bool = False) -> None:
    """FrozenBN's four tensors; ``tracked``: BatchNorm2d's, with its step
    counter."""
    for k in ("weight", "bias", "running_mean", "running_var"):
        m.leaf(f"{key}.{k}", f"{path}.{k}")
    if tracked:
        m.counter(f"{key}.num_batches_tracked")


def _linear(m: _Layout, key: str, path: str, fwd=np.transpose,
            inv=np.transpose) -> None:
    m.leaf(f"{key}.weight", f"{path}.weight", fwd, inv)
    m.leaf(f"{key}.bias", f"{path}.bias")


def _stage(m: _Layout, key: str, path: str, tracked: bool = False) -> None:
    """A ResNet stage's bottlenecks (a list in the tree)."""
    for bi in range(m.count(key, path)):
        k, p = f"{key}.{bi}", f"{path}.{bi}"
        for i in (1, 2, 3):
            _conv(m, f"{k}.conv{i}", f"{p}.conv{i}")
            _bn(m, f"{k}.bn{i}", f"{p}.bn{i}", tracked)
        if m.has(f"{k}.conv2.conv_offset_mask", f"{p}.conv2_offset"):
            _conv(m, f"{k}.conv2.conv_offset_mask", f"{p}.conv2_offset")
        if m.has(f"{k}.downsample", f"{p}.downsample"):
            _conv(m, f"{k}.downsample.0", f"{p}.downsample.conv")
            _bn(m, f"{k}.downsample.1", f"{p}.downsample.bn", tracked)


def _body(m: _Layout) -> None:
    """``backbone.body.*``: the stem and the stages the tree has."""
    body = "backbone.body."
    _conv(m, body + "stem.conv1", "backbone.stem.conv")
    _bn(m, body + "stem.bn1", "backbone.stem.bn")
    for si in range(1, 5):
        if m.has(f"{body}layer{si}", f"backbone.layer{si}"):
            _stage(m, f"{body}layer{si}", f"backbone.layer{si}")


def _rpn(m: _Layout) -> None:
    for src, dst in (("conv", "conv"), ("cls", "cls_logits"),
                     ("bbox", "bbox_pred")):
        _conv(m, f"rpn.head.{dst}", f"rpn.{src}")


def _deconv(a):
    return a.transpose(2, 3, 0, 1)  # [kh, kw, in, out] <-> [in, out, kh, kw]


def _mask_predictor(m: _Layout, path: str) -> None:
    """The deconv and the 1x1 logits."""
    key = "roi_heads.mask.predictor."
    m.leaf(key + "conv5_mask.weight", f"{path}.conv5_mask.weight", _deconv,
           _deconv)
    m.leaf(key + "conv5_mask.bias", f"{path}.conv5_mask.bias")
    _conv(m, key + "mask_fcn_logits", f"{path}.mask_fcn_logits")


def _fpn_layout(m: _Layout, cfg) -> None:
    _body(m)
    for i in range(4):
        _conv(m, f"backbone.fpn.fpn_inner{i + 1}", f"fpn.inner.{i}")
        _conv(m, f"backbone.fpn.fpn_layer{i + 1}", f"fpn.layer.{i}")
    _rpn(m)
    c, r = cfg.fpn_channels, cfg.pooler_resolution
    _linear(m, "roi_heads.box.feature_extractor.fc6", "box_head.fc6",
            lambda a: a.reshape(r, r, c, -1).transpose(2, 0, 1, 3)
            .reshape(c * r * r, -1).T,  # rows (H, W, C) -> (C, H, W)
            lambda a: a.T.reshape(c, r, r, -1).transpose(1, 2, 0, 3)
            .reshape(r * r * c, -1))
    _linear(m, "roi_heads.box.feature_extractor.fc7", "box_head.fc7")
    for name in ("cls_score", "bbox_pred"):
        _linear(m, f"roi_heads.box.predictor.{name}", f"box_head.{name}")
    if m.has("roi_heads.mask", "mask_head"):
        for i in range(1, 5):
            _conv(m, f"roi_heads.mask.feature_extractor.mask_fcn{i}",
                  f"mask_head.mask_fcn{i}")
        _mask_predictor(m, "mask_head")


def state_dict_from_jax(params: dict, cfg) -> dict:
    """``params``: the tree ``from_torch_state``/``init_params`` returns;
    ``cfg``: the port's (or the JAX) ``MaskRCNNConfig``. A tree without
    ``mask_head`` (Faster R-CNN) gives no ``roi_heads.mask.*``."""
    m = _Layout(tree=params)
    _fpn_layout(m, cfg)
    return m.result()


def jax_from_state_dict(sd: dict, cfg) -> dict:
    """The inverse of :func:`state_dict_from_jax`: the JAX Mask R-CNN or
    Faster R-CNN FPN tree (numpy f32 leaves)."""
    m = _Layout(state_dict=sd)
    _fpn_layout(m, cfg)
    return m.result()


def _c4_layout(m: _Layout) -> None:
    _body(m)
    _stage(m, "roi_heads.box.feature_extractor.head.layer4",
           "roi_head.layer4")
    _rpn(m)
    for name in ("cls_score", "bbox_pred"):
        _linear(m, f"roi_heads.box.predictor.{name}", f"box_pred.{name}")
    if m.has("roi_heads.mask.predictor", "mask_pred"):
        _mask_predictor(m, "mask_pred")


def c4_state_dict_from_jax(params: dict) -> dict:
    """The JAX C4 tree (``maskrcnn_c4.init_params`` / ``from_torch_state``)
    -> the port's :class:`~tpuseg_torch.models.maskrcnn_c4.MaskRCNNC4`
    state_dict; a tree without ``mask_pred`` (Faster R-CNN C4) gives no
    ``roi_heads.mask.*``."""
    m = _Layout(tree=params)
    _c4_layout(m)
    return m.result()


def c4_jax_from_state_dict(sd: dict) -> dict:
    """The inverse of :func:`c4_state_dict_from_jax`. A state_dict that
    carries upstream's duplicate ``roi_heads.mask.feature_extractor.*``
    (res5 again) gives the same tree: the JAX model shares one res5."""
    m = _Layout(state_dict=sd)
    _c4_layout(m)
    return m.result()


def _retinanet_layout(m: _Layout) -> None:
    _body(m)
    for i in range(3):
        _conv(m, f"backbone.fpn.fpn_inner{i + 2}", f"fpn.inner.{i}")
        _conv(m, f"backbone.fpn.fpn_layer{i + 2}", f"fpn.layer.{i}")
    _conv(m, "backbone.fpn.top_blocks.p6", "fpn.p6")
    _conv(m, "backbone.fpn.top_blocks.p7", "fpn.p7")
    for tower in ("cls_tower", "bbox_tower"):
        i = 0  # the port's Sequential holds a ReLU after each conv
        while m.has(f"rpn.head.{tower}.{2 * i}", f"{tower}.{i}"):
            _conv(m, f"rpn.head.{tower}.{2 * i}", f"{tower}.{i}")
            i += 1
    _conv(m, "rpn.head.cls_logits", "cls_logits")
    _conv(m, "rpn.head.bbox_pred", "bbox_pred")


def retinanet_state_dict_from_jax(params: dict) -> dict:
    """The JAX RetinaNet tree (``retinanet.init_params`` /
    ``from_torch_state``) -> the port's
    :class:`~tpuseg_torch.models.retinanet.RetinaNet` state_dict."""
    m = _Layout(tree=params)
    _retinanet_layout(m)
    return m.result()


def retinanet_jax_from_state_dict(sd: dict) -> dict:
    """The inverse of :func:`retinanet_state_dict_from_jax`."""
    m = _Layout(state_dict=sd)
    _retinanet_layout(m)
    return m.result()


def _conv_bn(m: _Layout, key: str, path: str) -> None:
    """A DarkNet conv (no bias) and its BatchNorm2d."""
    _conv(m, f"{key}.conv", f"{path}.conv")
    _bn(m, f"{key}.bn", f"{path}.bn", tracked=True)


def _darknet_layout(m: _Layout, key: str, path: str) -> None:
    """``nn/darknet.py``'s modules carry the JAX tree's paths as names."""
    _conv_bn(m, f"{key}.stem", f"{path}.stem")
    si = 0
    while m.has(f"{key}.stage{si}", f"{path}.stage{si}"):
        k, p = f"{key}.stage{si}", f"{path}.stage{si}"
        _conv_bn(m, f"{k}.down", f"{p}.down")
        for bi in range(m.count(f"{k}.blocks", f"{p}.blocks")):
            for c in ("conv1", "conv2"):
                _conv_bn(m, f"{k}.blocks.{bi}.{c}", f"{p}.blocks.{bi}.{c}")
        si += 1


def _yolact_layout(m: _Layout, cfg) -> None:
    """The keys of ``tpuseg/weights/yolact_map.py::to_torch_state`` (the
    port's DarkNet-53 under its own names, ``weights/yolact_map.py`` maps
    upstream's onto them)."""
    if cfg.backbone.startswith("resnet"):
        _conv(m, "backbone.conv1", "backbone.stem.conv")
        _bn(m, "backbone.bn1", "backbone.stem.bn", tracked=True)
        for si in range(4):
            _stage(m, f"backbone.layers.{si}", f"backbone.layer{si + 1}",
                   tracked=True)
    else:
        _darknet_layout(m, "backbone", "backbone")
    for i in range(3):
        _conv(m, f"fpn.lat_layers.{i}", f"fpn.lat.{i}")
        # the JAX tree applies pred[j] to P_{3+j}; pred_layers.0 is P5's
        _conv(m, f"fpn.pred_layers.{i}", f"fpn.pred.{2 - i}")
    for i in range(2):
        _conv(m, f"fpn.downsample_layers.{i}", f"fpn.down.{i}")
    for ci, idx in enumerate((0, 2, 4, 8, 10)):
        _conv(m, f"proto_net.{idx}", f"proto.conv{ci}")
    head = "prediction_layers.0."
    _conv(m, head + "upfeature.0", "pred.upfeature")
    for src, dst in (("bbox", "bbox_layer"), ("conf", "conf_layer"),
                     ("mask", "mask_layer")):
        _conv(m, head + dst, f"pred.{src}")
    if m.has("semantic_seg_conv", "semantic"):
        _conv(m, "semantic_seg_conv", "semantic")
    if m.has("maskiou_net", "maskiou"):
        for i in range(5):
            _conv(m, f"maskiou_net.maskiou_net.{2 * i}", f"maskiou.conv{i}")
        _conv(m, "maskiou_net.maskiou_net.10", "maskiou.conv_last")


def yolact_state_dict_from_jax(params: dict, cfg) -> dict:
    """The JAX package's YOLACT param tree (``init_params`` /
    ``yolact_map.from_torch_state``; numpy leaves) -> the port's
    :class:`~tpuseg_torch.models.yolact.Yolact` state_dict. ``cfg``: the
    port's or the JAX ``YolactConfig`` (its ``backbone`` picks ResNet or
    DarkNet-53)."""
    m = _Layout(tree=params)
    _yolact_layout(m, cfg)
    return m.result()


def yolact_jax_from_state_dict(sd: dict, cfg) -> dict:
    """The inverse of :func:`yolact_state_dict_from_jax`: the tree the JAX
    ``yolact_train --save_format npz`` writes."""
    m = _Layout(state_dict=sd)
    _yolact_layout(m, cfg)
    return m.result()


_POSE2SEG_FPN = ("toplayer", "latlayer1", "latlayer2", "latlayer3",
                 "smooth1", "smooth2", "smooth3")


def _pose2seg_layout(m: _Layout) -> None:
    _conv(m, "backbone.conv1", "backbone.stem.conv")
    _bn(m, "backbone.bn1", "backbone.stem.bn", tracked=True)
    for si in range(1, 5):
        _stage(m, f"backbone.layer{si}", f"backbone.layer{si}", tracked=True)
    for name in _POSE2SEG_FPN:
        _conv(m, f"backbone.{name}", f"fpn.{name}")
    _conv(m, "segnet.conv1", "seg.conv1")
    _bn(m, "segnet.bn1", "seg.bn1", tracked=True)
    _stage(m, "segnet.layers", "seg.units", tracked=True)
    _conv(m, "segnet.conv2", "seg.classifier")


def pose2seg_state_dict_from_jax(params: dict) -> dict:
    """The JAX package's Pose2Seg tree (``pose2seg.init_params`` /
    ``pose2seg_from_torch``; numpy leaves, any widths) -> the port's
    :class:`~tpuseg_torch.models.pose2seg.Pose2Seg` state_dict, upstream's
    keys: ``backbone.{conv1,bn1,layer1-4,toplayer,latlayer1-3,
    smooth1-3}.*``, ``segnet.{conv1,bn1,layers.i,conv2}.*``."""
    m = _Layout(tree=params)
    _pose2seg_layout(m)
    return m.result()


def pose2seg_jax_from_state_dict(sd: dict) -> dict:
    """The inverse of :func:`pose2seg_state_dict_from_jax`: the tree the
    JAX ``pose2seg_train --save <path>.npz`` writes."""
    m = _Layout(state_dict=sd)
    _pose2seg_layout(m)
    return m.result()


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
