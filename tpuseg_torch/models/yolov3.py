"""YOLOv3 detector (port of ``tpuseg/models/yolov3.py``; yolo.jittor).

DarkNet-53, three detection heads at strides (32, 16, 8) with three
anchors each (the COCO yolov3.cfg values, in network-input pixels), a
letterboxed input, the confidence filter and a class-aware NMS. Every
stage runs on fixed shapes: :func:`postprocess` keeps the top
``pre_nms_topk`` scores of each image, runs one class-aware NMS over the
batch (``ops/nms.py::batched_nms_mask``: one NMS kernel launch on the
card) and keeps the top ``max_det`` survivors, padded.

The modules are named after the JAX package's param tree (``backbone``,
``neck{i}.{j}``, ``head{i}.conv``, ``head{i}.out``, ``branch{i}``), so the
JAX npz params map onto them key for key (``weights/from_jax.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from tpuseg_torch.core.boxes import gather_along_n, masked_topk
from tpuseg_torch.nn.darknet import ConvBNLeaky, DarkNet53
from tpuseg_torch.ops import nms as nms_ops

ANCHORS = (
    ((116, 90), (156, 198), (373, 326)),  # stride 32 head (from C5)
    ((30, 61), (62, 45), (59, 119)),  # stride 16
    ((10, 13), (16, 30), (33, 23)),  # stride 8
)
STRIDES = (32, 16, 8)
NUM_ANCHORS = 3


@dataclass(frozen=True)
class YoloV3Config:
    num_classes: int = 80
    input_size: int = 416
    conf_thresh: float = 0.005
    nms_thresh: float = 0.45
    max_det: int = 100
    pre_nms_topk: int = 1000

    @property
    def num_attrib(self):
        return 5 + self.num_classes


def convset(cin: int, mid: int) -> nn.ModuleList:
    """The neck's five convs: 1x1 (mid), 3x3 (2 mid), 1x1, 3x3, 1x1."""
    return nn.ModuleList([
        ConvBNLeaky(cin, mid, 1), ConvBNLeaky(mid, mid * 2, 3),
        ConvBNLeaky(mid * 2, mid, 1), ConvBNLeaky(mid, mid * 2, 3),
        ConvBNLeaky(mid * 2, mid, 1)])


class Head(nn.Module):
    def __init__(self, cin: int, out_ch: int):
        super().__init__()
        self.conv = ConvBNLeaky(cin, cin * 2, 3)
        self.out = nn.Conv2d(cin * 2, out_ch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.conv(x))


def resize_nearest(x: torch.Tensor, out_hw: tuple) -> torch.Tensor:
    """Nearest resize with the floor rule (torch's ``mode="nearest"``,
    the JAX ``resize_nearest``): output row i reads row i * h // oh."""
    h, w = x.shape[-2:]
    ridx = torch.arange(out_hw[0], device=x.device) * h // out_hw[0]
    cidx = torch.arange(out_hw[1], device=x.device) * w // out_hw[1]
    return x[:, :, ridx][:, :, :, cidx]


class YoloV3(nn.Module):
    def __init__(self, cfg: YoloV3Config = YoloV3Config()):
        super().__init__()
        self.cfg = cfg
        out_ch = NUM_ANCHORS * cfg.num_attrib
        self.backbone = DarkNet53()
        self.neck0 = convset(1024, 512)
        self.head0 = Head(512, out_ch)
        self.branch0 = ConvBNLeaky(512, 256, 1)
        self.neck1 = convset(768, 256)  # concat(256 upsampled, C4 512)
        self.head1 = Head(256, out_ch)
        self.branch1 = ConvBNLeaky(256, 128, 1)
        self.neck2 = convset(384, 128)
        self.head2 = Head(128, out_ch)

    def forward(self, images: torch.Tensor) -> list:
        """images [B, 3, S, S] normalised -> the three raw head maps
        [B, h, w, 3 * (5 + C)] (channels last, as the JAX package's) at
        strides (32, 16, 8)."""
        feats = self.backbone(images)
        outs = []
        x = feats["c5"]
        lateral = (None, feats["c4"], feats["c3"])
        for i in range(3):
            if i:
                b = getattr(self, f"branch{i - 1}")(x)
                b = resize_nearest(b, lateral[i].shape[-2:])
                x = torch.cat([b, lateral[i]], dim=1)
            for conv in getattr(self, f"neck{i}"):
                x = conv(x)
            outs.append(getattr(self, f"head{i}")(x).permute(0, 2, 3, 1))
        return outs

    def layers(self):
        """The conv layers in yolov3.cfg order: (module, has BatchNorm)."""
        for layer in self.backbone.layers():
            yield layer, True
        for i in range(3):
            if i:
                yield getattr(self, f"branch{i - 1}"), True
            for conv in getattr(self, f"neck{i}"):
                yield conv, True
            head = getattr(self, f"head{i}")
            yield head.conv, True
            yield head.out, False


def build_model(cfg: YoloV3Config = YoloV3Config(),
                generator: torch.Generator | None = None) -> YoloV3:
    """A CPU model in eval mode: random weights from ``generator`` if one
    is given (conv weights N(0, 2/fan_in), as the JAX ``kaiming_conv``,
    biases 0, BatchNorm the identity), otherwise uninitialised storage for
    ``load_state_dict`` or the ``.weights`` reader."""
    with torch.device("meta"):
        model = YoloV3(cfg)
    model = model.to_empty(device="cpu")
    if generator is not None:
        with torch.no_grad():
            for name, t in model.state_dict().items():
                if name.endswith(("bias", "running_mean",
                                  "num_batches_tracked")):
                    t.zero_()
                elif t.ndim == 4:
                    t.normal_(0.0, (2.0 / t[0].numel()) ** 0.5,
                              generator=generator)
                else:  # BN weight and running_var
                    t.fill_(1.0)
    else:
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                t.zero_()
    return model.eval()


def decode(outs: list, cfg: YoloV3Config):
    """Raw head maps -> (boxes xyxy [B, N, 4] in input px, obj [B, N],
    class probabilities [B, N, C]), N = sum over levels of h * w * 3, in
    (row, column, anchor) order."""
    all_boxes, all_obj, all_cls = [], [], []
    for out, anchors, stride in zip(outs, ANCHORS, STRIDES):
        b, h, w, _ = out.shape
        out = out.reshape(b, h, w, NUM_ANCHORS, cfg.num_attrib)
        dev, dt = out.device, out.dtype
        gy = torch.arange(h, device=dev, dtype=dt)[:, None, None]
        gx = torch.arange(w, device=dev, dtype=dt)[None, :, None]
        txy = torch.sigmoid(out[..., 0:2])
        bx = (txy[..., 0] + gx) * stride
        by = (txy[..., 1] + gy) * stride
        aw = torch.tensor([a[0] for a in anchors], device=dev, dtype=dt)
        ah = torch.tensor([a[1] for a in anchors], device=dev, dtype=dt)
        bw = torch.exp(out[..., 2]) * aw
        bh = torch.exp(out[..., 3]) * ah
        boxes = torch.stack([bx - bw / 2, by - bh / 2, bx + bw / 2,
                             by + bh / 2], dim=-1)
        n = h * w * NUM_ANCHORS
        all_boxes.append(boxes.reshape(b, n, 4))
        all_obj.append(torch.sigmoid(out[..., 4]).reshape(b, n))
        all_cls.append(torch.sigmoid(out[..., 5:]).reshape(
            b, n, cfg.num_classes))
    return (torch.cat(all_boxes, 1), torch.cat(all_obj, 1),
            torch.cat(all_cls, 1))


def postprocess(boxes: torch.Tensor, obj: torch.Tensor, cls_probs: torch.Tensor,
                cfg: YoloV3Config) -> dict:
    """Per image: score = obj * max class probability, the top
    ``pre_nms_topk`` of those above ``conf_thresh`` (ties to the lower
    index), class-aware NMS over the whole batch in one call, the top
    ``max_det`` survivors -> padded [B, max_det] {boxes, scores, classes,
    valid}."""
    cls_conf, cls_id = cls_probs.max(dim=-1)
    scores = obj * cls_conf
    top_s, idx, top_valid = masked_topk(scores, scores > cfg.conf_thresh,
                                        cfg.pre_nms_topk)
    sel_boxes = gather_along_n(boxes, idx)
    sel_cls = gather_along_n(cls_id, idx)
    keep = nms_ops.batched_nms_mask(sel_boxes, top_s, sel_cls,
                                    cfg.nms_thresh, valid=top_valid)
    fin_s, fin_idx, fin_valid = masked_topk(top_s, keep, cfg.max_det)
    return {"boxes": gather_along_n(sel_boxes, fin_idx),
            "scores": torch.where(fin_valid, fin_s, torch.zeros_like(fin_s)),
            "classes": gather_along_n(sel_cls, fin_idx),
            "valid": fin_valid}


def detect(model: YoloV3, images: torch.Tensor, cfg: YoloV3Config) -> dict:
    """Normalised images [B, 3, S, S] -> padded detections. The head maps
    are decoded in f32 whatever the model's dtype."""
    outs = [o.float() for o in model(images)]
    return postprocess(*decode(outs, cfg), cfg)
