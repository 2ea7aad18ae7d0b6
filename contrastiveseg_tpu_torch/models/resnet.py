"""ResNet backbones, with the dilated-8/16 variants (NCHW).

Counterpart of ``contrastiveseg_tpu/models/resnet.py`` (:35-150, :300-350;
the reference's resnet_models.py:107-180 and resnet_backbone.py:21-118):

  * the ``deep_base`` stem of three 3x3 convs (s2 64 -> 64 -> 128), or the
    7x7 s2 stem, then a 3x3 s2 max-pool;
  * four stages of Bottlenecks (BasicBlocks for resnet18/34); the dilated
    specs turn the strides of layer3/4 into dilations by the
    ``_nostride_dilate`` rule: the block that had the stride gets d/2, the
    others d, and layer4's are scaled by ``multi_grid``;
  * ``forward`` returns ``[stem, pool, c1, c2, c3, c4]``.

The max-pool keeps the JAX package's floor sizes (``resnet.py:16-19``):
``MaxPool2d(3, 2, 1)``, where the reference has ``ceil_mode=True``.  A
512x1024 crop gives 128x256 here and 129x257 in the reference.

Module names are the reference's torch keys: ``resinit.conv{1,2,3}`` /
``resinit.bn{1,2,3}`` (the 7x7 stem ``resinit.conv1``/``resinit.bn1``) and
``layer{i}.{k}`` (``utils/torch_import.resnet_backbone_path``).

ResNeSt (``radix``, JAX :45-68, :190-270; ``deepbase_resnest{50,101,200,
269}_dilated8``) builds each block as ``VariantBottleneck``, whose 3x3 is a
``SplitAttentionConv``: ``radix`` grouped splits, fused by a softmax over
the splits of an MLP on their pooled sum.  It keeps the JAX package's two
documented divergences from the reference: a strided conv where the
reference has avg-pool downsampling (avd), and an ungrouped attention MLP.
The MLP's BatchNorm (``fc_bn``, flax momentum 0.9, torch's 0.1) normalises
over the batch.  The JAX package has no reference ``.pth`` map for ResNeSt,
and the port adds none.  The other variant families (``groups``,
``width_mult``, ``dcn_layer4``) and ``WiderResNetA2`` are not ported;
building one raises.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from contrastiveseg_tpu_torch.models.layers import (
    BasicBlock,
    Bottleneck,
    ConvBN,
    TorchBatchNorm,
    conv,
)

_LATER = "is not ported yet: ROADMAP 7 (the ResNet variant families)"


@dataclasses.dataclass(frozen=True)
class ResNetSpec:
    layers: tuple[int, ...]  # blocks per stage
    block: str = "bottleneck"  # bottleneck | basic (resnet18/34)
    deep_base: bool = True
    dilate_scale: int | None = None  # None | 8 | 16
    multi_grid: tuple[int, ...] | None = (1, 1, 1)
    groups: int = 1
    width_per_group: int = 64
    width_mult: float = 1.0
    dcn_layer4: bool = False
    radix: int = 0


RESNET_SPECS: dict[str, ResNetSpec] = {
    "resnet50": ResNetSpec((3, 4, 6, 3), deep_base=False),
    "resnet50_dilated8": ResNetSpec((3, 4, 6, 3), deep_base=False, dilate_scale=8),
    "resnet101": ResNetSpec((3, 4, 23, 3), deep_base=False),
    "resnet101_dilated8": ResNetSpec((3, 4, 23, 3), dilate_scale=8),
    "resnet101_dilated16": ResNetSpec((3, 4, 23, 3), dilate_scale=16),
    "resnet152": ResNetSpec((3, 8, 36, 3), deep_base=False),
    "resnext101_dilated8": ResNetSpec(
        (3, 4, 23, 3), deep_base=False, dilate_scale=8, groups=32, width_per_group=4),
    "wide_resnet101_dilated8": ResNetSpec(
        (3, 4, 23, 3), deep_base=False, dilate_scale=8, width_mult=2.0),
    "resnest101_dilated8": ResNetSpec(
        (3, 4, 23, 3), dilate_scale=8, radix=2, width_per_group=64),
    "resnet101_dilated8_dcn": ResNetSpec((3, 4, 23, 3), dilate_scale=8, dcn_layer4=True),
}

# The WiderResNetA2 arch strings (resnet_models.py:288-313); refused.
WIDE_RESNET_ARCHS = frozenset(
    ("wide_resnet16_dilated8", "wide_resnet20_dilated8", "wide_resnet38_dilated8"))


def resolve_arch(name: str) -> str:
    """Exact spec names first (deep and plain stems coexist in the zoo),
    then the name without its ``deepbase_`` prefix."""
    if name in RESNET_SPECS:
        return name
    return name.replace("deepbase_", "")


def _zoo() -> None:
    """Every arch string the reference backbone selector accepts
    (resnet_backbone.py:137-290), with its exact ``deep_base``."""
    layers = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3),
              101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
    for depth in (18, 34, 50, 101, 152):
        block = "basic" if depth in (18, 34) else "bottleneck"
        for deep in (False, True):
            for dil in (None, 8, 16):
                name = ("deepbase_" if deep else "") + f"resnet{depth}" + (
                    f"_dilated{dil}" if dil else "")
                RESNET_SPECS.setdefault(name, ResNetSpec(
                    layers[depth], block=block, deep_base=deep, dilate_scale=dil))
    for wpg in (8, 16, 32, 48):
        RESNET_SPECS.setdefault(
            f"resnext101_32x{wpg}d_dilated8",
            ResNetSpec((3, 4, 23, 3), deep_base=False, dilate_scale=8,
                       groups=32, width_per_group=wpg))
    resnest_layers = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3),
                      200: (3, 24, 36, 3), 269: (3, 30, 48, 8)}
    for depth, n in resnest_layers.items():
        RESNET_SPECS.setdefault(
            f"deepbase_resnest{depth}_dilated8",
            ResNetSpec(n, deep_base=True, dilate_scale=8, radix=2, width_per_group=64))
    for depth in (50, 101):
        for dil in (8, 16):
            RESNET_SPECS.setdefault(
                f"deepbase_dcn_resnet{depth}_dilated{dil}",
                ResNetSpec(layers[depth], deep_base=True, dilate_scale=dil,
                           dcn_layer4=True))


_zoo()


def backbone_spec(name: str) -> ResNetSpec:
    """The spec of ``network.backbone`` ``name``; ``WiderResNetA2`` raises
    ``NotImplementedError``, a name outside the zoo ``KeyError``."""
    if name in WIDE_RESNET_ARCHS:
        raise NotImplementedError(f"network.backbone={name!r} (WiderResNetA2) {_LATER}")
    arch = resolve_arch(name)
    if arch not in RESNET_SPECS:
        raise KeyError(f"unknown ResNet backbone {name!r}")
    return RESNET_SPECS[arch]


def _stage_plan(spec: ResNetSpec) -> list[tuple[int, int, int, list[int]]]:
    """Per stage (width, blocks, stride, per-block dilation), by the
    ``_nostride_dilate`` rule."""
    plan = []
    for si, (w, n) in enumerate(zip((64, 128, 256, 512), spec.layers)):
        stride = 1 if si == 0 else 2
        dil = [1] * n
        if spec.dilate_scale == 8 and si == 2:
            stride, dil = 1, [2] * n
            dil[0] = 1  # the former stride conv gets d/2
        if spec.dilate_scale in (8, 16) and si == 3:
            stride = 1
            base = 4 if spec.dilate_scale == 8 else 2
            mg = spec.multi_grid or (1, 1, 1)
            dil = [int(base * mg[min(i, len(mg) - 1)]) for i in range(n)]
            dil[0] = max(1, dil[0] // 2)
        plan.append((w, n, stride, dil))
    return plan


class SplitAttentionConv(nn.Module):
    """ResNeSt's split-attention 3x3: a conv to ``radix`` splits of
    ``features`` (groups ``groups * radix``) -> BN -> ReLU; the splits'
    sum, pooled over the image, through ``fc1`` -> ``fc_bn`` -> ReLU ->
    ``fc2`` gives each split a softmax weight per channel (rSoftMax); the
    output is the weighted sum of the splits."""

    def __init__(self, in_ch: int, features: int, radix: int = 2, groups: int = 1,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.radix, self.features = radix, features
        self.conv = nn.Conv2d(in_ch, features * radix, 3, stride, padding=dilation,
                              dilation=dilation, groups=groups * radix, bias=False)
        self.bn = TorchBatchNorm(features * radix)
        inter = max(features * radix // 4, 32)
        self.fc1 = nn.Linear(features, inter)
        self.fc_bn = TorchBatchNorm(inter)
        self.fc2 = nn.Linear(inter, features * radix)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn(self.conv(x)))
        b, _, h, w = y.shape
        splits = y.view(b, self.radix, self.features, h, w)
        gap = splits.sum(1).mean((2, 3))
        a = torch.relu(self.fc_bn(self.fc1(gap)[..., None, None]).flatten(1))
        att = self.fc2(a).view(b, self.radix, self.features).softmax(1)
        return (splits * att[..., None, None]).sum(1)


class VariantBottleneck(nn.Module):
    """The JAX ``VariantBottleneck``'s ``radix`` branch: ``Bottleneck``
    (``conv1``/``bn1``, ``conv3``/``bn3``, ``downsample``) with a
    ``SplitAttentionConv`` ``conv2`` that carries its own BN and strides."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1, radix: int = 2):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = SplitAttentionConv(planes, planes, radix, stride=stride, dilation=dilation)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = TorchBatchNorm(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = (ConvBN(inplanes, planes * 4, 1, stride, use_relu=False)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.conv2(self.relu(self.bn1(self.conv1(x))))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


class ResNet(nn.Module):
    """Returns ``[stem, pool, c1, c2, c3, c4]`` NCHW feature maps."""

    def __init__(self, spec: ResNetSpec):
        super().__init__()
        variant = [f for f, plain in (("groups", 1), ("width_mult", 1.0),
                                      ("dcn_layer4", False))
                   if getattr(spec, f) != plain]
        if variant:
            raise NotImplementedError(f"a ResNet with {', '.join(variant)} {_LATER}")
        stem = (((3, 64, 2), (64, 64, 1), (64, 128, 1)) if spec.deep_base
                else ((3, 64, 2),))
        k = 3 if spec.deep_base else 7
        self.resinit = nn.Module()
        for i, (cin, cout, stride) in enumerate(stem, 1):
            self.resinit.add_module(f"conv{i}", conv(cin, cout, k, stride))
            self.resinit.add_module(f"bn{i}", TorchBatchNorm(cout))
        self.n_stem = len(stem)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        basic = spec.block == "basic"
        expansion = 1 if basic else Bottleneck.expansion
        inplanes = stem[-1][1]
        for si, (w, n, stride, dil) in enumerate(_stage_plan(spec), 1):
            blocks = []
            for b in range(n):
                s = stride if b == 0 else 1
                ds = b == 0 and (s != 1 or inplanes != w * expansion)
                if spec.radix:
                    blocks.append(VariantBottleneck(inplanes, w, s, downsample=ds,
                                                    dilation=dil[b], radix=spec.radix))
                else:
                    block = BasicBlock if basic else Bottleneck
                    blocks.append(block(inplanes, w, s, downsample=ds, dilation=dil[b]))
                inplanes = w * expansion
            self.add_module(f"layer{si}", nn.Sequential(*blocks))
        self.channels = tuple(w * expansion for w in (64, 128, 256, 512))  # c1..c4
        self.radix = spec.radix

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        for i in range(1, self.n_stem + 1):
            x = self.relu(getattr(self.resinit, f"bn{i}")(getattr(self.resinit, f"conv{i}")(x)))
        feats = [x]
        x = self.maxpool(x)
        feats.append(x)
        for si in range(1, 5):
            x = getattr(self, f"layer{si}")(x)
            feats.append(x)
        return feats
