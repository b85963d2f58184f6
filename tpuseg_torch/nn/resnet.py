"""ResNet bodies (port of ``tpuseg/nn/resnet.py``), in two flavours.

:class:`ResNet`, detectron's: Caffe2-style FrozenBatchNorm2d, the stride
on the 1x1 conv (``STRIDE_IN_1X1=True``), stem ``conv1``/``bn1``. Attribute
paths follow maskrcnn-benchmark (``stem.conv1``, ``layer1.0.conv1``,
``layer1.0.downsample.0``), so the upstream state_dict keys load as they are.

:class:`ResNetBackbone`, YOLACT's (dbolya ``backbone.py``), torchvision
style: BatchNorm2d (eps 1e-5, eval mode at inference), the stride on the
3x3 conv, DCNv2 in place of the 3x3 conv of chosen blocks, attribute paths
``conv1``, ``bn1``, ``layers.{s}.{b}.conv1/bn1/conv2[.conv_offset_mask]/
bn2/conv3/bn3/downsample.{0,1}``.

:class:`ResNetTV`, Pose2Seg's: the same torchvision blocks under
torchvision's own names (``conv1``, ``bn1``, ``layer1``..``layer4``), with
an optional dilated C5.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpuseg_torch.nn.layers import FrozenBatchNorm2d
from tpuseg_torch.ops.deform_conv import ModulatedDeformConv2d

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def _conv(cin, cout, k, stride=1, padding=0, dilation=1):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding,
                     dilation=dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, stride: int):
        super().__init__()
        # stride_in_1x1: the stride sits on conv1, conv2 keeps stride 1
        self.conv1 = _conv(cin, mid, 1, stride=stride)
        self.bn1 = FrozenBatchNorm2d(mid)
        self.conv2 = _conv(mid, mid, 3, padding=1)
        self.bn2 = FrozenBatchNorm2d(mid)
        self.conv3 = _conv(mid, cout, 1)
        self.bn3 = FrozenBatchNorm2d(cout)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride=stride),
                                            FrozenBatchNorm2d(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class Stem(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.conv1 = _conv(3, width, 7, stride=2, padding=3)
        self.bn1 = FrozenBatchNorm2d(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.max_pool2d(x, 3, 2, padding=1)


class ResNet(nn.Module):
    """x [B,3,H,W] -> [c2 /4, c3 /8, c4 /16, c5 /32].

    ``width`` is the stem width (64 for R-50); stage ``i`` has
    ``width * 2**i`` bottleneck channels and four times that at its output.
    ``freeze_at`` (detectron FREEZE_CONV_BODY_AT) freezes the stem
    (``freeze_at >= 1``) and ``layer1`` .. ``layer{freeze_at - 1}``: their
    parameters get ``requires_grad=False``, so no gradient reaches them, as
    the JAX ``stop_gradient`` after each frozen stage does
    (``tpuseg/nn/resnet.py:103,128``). The FrozenBN tensors are buffers and
    never train. ``num_stages=3`` is the C4 body (stem and layer1-3, the
    last output at stride 16 with 1024 channels); its layer4 is the box
    head's :class:`ResNetHead`.
    """

    def __init__(self, depth: int = 50, width: int = 64, freeze_at: int = 2,
                 num_stages: int = 4):
        super().__init__()
        self.freeze_at = freeze_at
        self.num_stages = num_stages
        self.stem = Stem(width)
        cin = width
        for si, nblocks in enumerate(STAGE_BLOCKS[depth][:num_stages]):
            self.add_module(f"layer{si + 1}",
                            _stage(cin, width * 2 ** si, nblocks,
                                   1 if si == 0 else 2))
            cin = width * 2 ** si * 4
        self.out_channels = tuple(width * 2 ** si * 4
                                  for si in range(num_stages))
        frozen = ([self.stem] if freeze_at >= 1 else []) + [
            getattr(self, f"layer{si + 1}")
            for si in range(min(freeze_at - 1, num_stages))]
        for m in frozen:
            m.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> list:
        x = self.stem(x)
        feats = []
        for si in range(self.num_stages):
            x = getattr(self, f"layer{si + 1}")(x)
            feats.append(x)
        return feats


def _stage(cin: int, mid: int, nblocks: int, stride: int) -> nn.Sequential:
    """``nblocks`` bottlenecks of ``mid`` channels, ``4 * mid`` out, the
    stride on the first."""
    cout = mid * 4
    return nn.Sequential(*(Bottleneck(cin if bi == 0 else cout, mid, cout,
                                      stride if bi == 0 else 1)
                           for bi in range(nblocks)))


class ResNetHead(nn.Module):
    """The C4 models' res5 (upstream ``ResNetHead``): ``layer4`` on the
    pooled 14x14 rois of ``in_channels`` (the C4 body's output, 1024 at
    R-50) -> [N, 2 * in_channels, 7, 7], the stride on the first block's
    1x1 conv, FrozenBN."""

    def __init__(self, depth: int, in_channels: int):
        super().__init__()
        self.layer4 = _stage(in_channels, in_channels // 2,
                             STAGE_BLOCKS[depth][3], 2)
        self.out_channels = 2 * in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer4(x)


class BottleneckTV(nn.Module):
    """torchvision bottleneck: the stride on the 3x3 conv, which is a
    :class:`ModulatedDeformConv2d` (with a bias, as upstream's DCNv2) when
    ``dcn``, else a plain conv dilated by ``dilation`` (padded as much)."""

    def __init__(self, cin: int, mid: int, cout: int, stride: int,
                 dcn: bool, eps: float, dilation: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, mid, 1)
        self.bn1 = nn.BatchNorm2d(mid, eps=eps)
        self.conv2 = (ModulatedDeformConv2d(mid, mid, 3, stride=stride)
                      if dcn else _conv(mid, mid, 3, stride=stride,
                                        padding=dilation, dilation=dilation))
        self.bn2 = nn.BatchNorm2d(mid, eps=eps)
        self.conv3 = _conv(mid, cout, 1)
        self.bn3 = nn.BatchNorm2d(cout, eps=eps)
        self.downsample = None
        if cin != cout or stride != 1:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride=stride),
                                            nn.BatchNorm2d(cout, eps=eps))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetBackbone(nn.Module):
    """YOLACT's ResNet: x [B,3,H,W] -> [c2 /4, c3 /8, c4 /16, c5 /32].

    ``dcn_stages`` (0-based) and ``dcn_interval`` pick the deformable
    blocks, as ``ResNetConfig.block_uses_dcn``: block ``b`` of stage ``s``
    when ``s in dcn_stages and b % dcn_interval == 0`` (YOLACT++: stages
    1-3, interval 1 for R-50, 3 for R-101). The BatchNorms run in eval mode
    at inference, as the JAX ``batch_norm_inference`` does.
    """

    def __init__(self, depth: int = 50, dcn_stages=(), dcn_interval: int = 1,
                 width: int = 64, eps: float = 1e-5):
        super().__init__()
        self.conv1 = _conv(3, width, 7, stride=2, padding=3)
        self.bn1 = nn.BatchNorm2d(width, eps=eps)
        self.layers = nn.ModuleList(_tv_stages(
            depth, width, eps,
            lambda si, bi: si in dcn_stages and bi % dcn_interval == 0))
        self.out_channels = tuple(width * 2 ** si * 4 for si in range(4))

    def forward(self, x: torch.Tensor) -> list:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for layer in self.layers:
            x = layer(x)
            feats.append(x)
        return feats


def _tv_stages(depth: int, width: int, eps: float, dcn=lambda si, bi: False,
               dilation_c5: int = 1) -> list:
    """The four stages of torchvision bottlenecks: stage ``si`` has
    ``width * 2**si`` bottleneck channels, the stride 2 on its first block
    but the first stage's; ``dcn(si, bi)`` picks the deformable blocks;
    with ``dilation_c5 > 1`` the last stage keeps stride 1 and dilates its
    3x3 convs."""
    stages, cin = [], width
    for si, nblocks in enumerate(STAGE_BLOCKS[depth]):
        mid = width * 2 ** si
        cout = mid * 4
        dilation = dilation_c5 if si == 3 else 1
        stride = 1 if si == 0 or dilation > 1 else 2
        stages.append(nn.Sequential(*(
            BottleneckTV(cin if bi == 0 else cout, mid, cout,
                         stride if bi == 0 else 1, dcn(si, bi), eps, dilation)
            for bi in range(nblocks))))
        cin = cout
    return stages


class ResNetTV(nn.Module):
    """Pose2Seg's ResNet (upstream's resnet50FPN body, torchvision names):
    x [B,3,H,W] -> [c2 /4, c3 /8, c4 /16, c5], BatchNorm2d (eps 1e-5), the
    stride on the 3x3 conv. With ``dilation_c5 > 1`` layer4 keeps stride 1
    (C5 at /16) and every one of its 3x3 convs is dilated by
    ``dilation_c5``, as ``tpuseg/nn/resnet.py::forward`` runs the dilated
    C5. Nothing is frozen: the BatchNorms train with the model."""

    def __init__(self, depth: int = 50, width: int = 64,
                 dilation_c5: int = 1, eps: float = 1e-5):
        super().__init__()
        self.conv1 = _conv(3, width, 7, stride=2, padding=3)
        self.bn1 = nn.BatchNorm2d(width, eps=eps)
        for si, stage in enumerate(_tv_stages(depth, width, eps,
                                              dilation_c5=dilation_c5)):
            self.add_module(f"layer{si + 1}", stage)
        self.out_channels = tuple(width * 2 ** si * 4 for si in range(4))

    def forward(self, x: torch.Tensor) -> list:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        feats = []
        for si in range(4):
            x = getattr(self, f"layer{si + 1}")(x)
            feats.append(x)
        return feats
