"""HRNet backbone (NCHW).

Counterpart of ``contrastiveseg_tpu/models/hrnet.py`` (the reference's
HighResolutionNet, hrnet_backbone.py:108-801): stem of two stride-2 3x3
convs, layer1 = 4 Bottlenecks, then stages 2/3/4 of HighResolutionModules
with full cross-resolution fusion (1x1 conv + BN + bilinear align_corners
upsample for coarser->finer, chains of stride-2 3x3 conv+BN for
finer->coarser).  The TPU-only ``lane_pad``, the ``remat_*`` flags and
``HRNetNext`` are not ported.  ``pallas_conv`` routes the branch
BasicBlocks' eligible 3x3 convs through K2 (``models/layers.PallasConv3x3``),
as the JAX flag does; at W48 that is branch 0 (C=48), 64 convs a forward.

Module names are the upstream torch ``state_dict`` keys: ``conv1``/``bn1``,
``layer1.{k}``, ``transition{1,2,3}.{i}``, ``stage{2,3,4}.{m}.branches`` and
``.fuse_layers``.  Fusion sums in the JAX package's order (own branch
first, then j = 0, 1, ...).
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
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_align_corners_nchw


@dataclasses.dataclass(frozen=True)
class StageSpec:
    num_modules: int
    num_blocks: int
    num_channels: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class HRNetSpec:
    stem_width: int
    stage1_blocks: int
    stage1_width: int
    stage2: StageSpec
    stage3: StageSpec
    stage4: StageSpec

    @property
    def out_channels(self) -> tuple[int, ...]:
        return self.stage4.num_channels


def _hrnet_spec(w: int) -> HRNetSpec:
    return HRNetSpec(
        stem_width=64,
        stage1_blocks=4,
        stage1_width=64,
        stage2=StageSpec(1, 4, (w, 2 * w)),
        stage3=StageSpec(4, 4, (w, 2 * w, 4 * w)),
        stage4=StageSpec(3, 4, (w, 2 * w, 4 * w, 8 * w)),
    )


HRNET_SPECS: dict[str, HRNetSpec] = {
    "hrnet18": _hrnet_spec(18),
    "hrnet32": _hrnet_spec(32),
    "hrnet48": _hrnet_spec(48),
    "hrnet64": _hrnet_spec(64),
}


class HighResolutionModule(nn.Module):
    """Parallel branches of BasicBlocks + full fusion."""

    def __init__(self, in_channels: tuple[int, ...],
                 num_channels: tuple[int, ...], num_blocks: int,
                 pallas_conv: bool = False):
        super().__init__()
        nb = len(num_channels)
        self.branches = nn.ModuleList()
        for i in range(nb):
            blocks = []
            inplanes = in_channels[i]
            for k in range(num_blocks):
                blocks.append(BasicBlock(
                    inplanes, num_channels[i],
                    downsample=(k == 0 and inplanes != num_channels[i]),
                    pallas=pallas_conv))
                inplanes = num_channels[i]
            self.branches.append(nn.Sequential(*blocks))
        self.fuse_layers = nn.ModuleList()
        if nb == 1:
            return
        for i in range(nb):
            row = nn.ModuleList()
            for j in range(nb):
                if j > i:  # coarser -> finer: 1x1 conv + BN, then upsample
                    row.append(ConvBN(num_channels[j], num_channels[i], 1,
                                      use_relu=False))
                elif j == i:
                    row.append(None)
                else:  # finer -> coarser: chain of stride-2 3x3 convs
                    chain = []
                    for k in range(i - j):
                        last = k == i - j - 1
                        chain.append(ConvBN(
                            num_channels[j],
                            num_channels[i] if last else num_channels[j],
                            3, 2, use_relu=not last))
                    row.append(nn.Sequential(*chain))
            self.fuse_layers.append(row)

    def forward(self, xs: list[torch.Tensor]) -> list[torch.Tensor]:
        feats = [branch(x) for branch, x in zip(self.branches, xs)]
        if len(feats) == 1:
            return feats
        fused = []
        for i, row in enumerate(self.fuse_layers):
            h, w = feats[i].shape[2], feats[i].shape[3]
            acc = feats[i]
            for j, layer in enumerate(row):
                if j == i:
                    continue
                y = layer(feats[j])
                if j > i:
                    y = resize_bilinear_align_corners_nchw(y, (h, w))
                acc = acc + y
            fused.append(torch.relu(acc))
        return fused


class HRNet(nn.Module):
    """Returns the four multi-resolution NCHW feature maps (strides 4/8/16/32)."""

    def __init__(self, spec: HRNetSpec, pallas_conv: bool = False):
        super().__init__()
        s = spec
        self.conv1 = conv(3, s.stem_width, 3, 2)
        self.bn1 = TorchBatchNorm(s.stem_width)
        self.conv2 = conv(s.stem_width, s.stem_width, 3, 2)
        self.bn2 = TorchBatchNorm(s.stem_width)
        self.relu = nn.ReLU()
        blocks, inplanes = [], s.stem_width
        for k in range(s.stage1_blocks):
            blocks.append(Bottleneck(inplanes, s.stage1_width,
                                     downsample=(k == 0)))
            inplanes = s.stage1_width * Bottleneck.expansion
        self.layer1 = nn.Sequential(*blocks)

        pre = (inplanes,)
        for idx, stage in ((2, s.stage2), (3, s.stage3), (4, s.stage4)):
            trans = nn.ModuleList()
            for i, c in enumerate(stage.num_channels):
                if i < len(pre):
                    trans.append(ConvBN(pre[i], c, 3, 1)
                                 if pre[i] != c else None)
                else:  # the new coarsest branch, a nested Sequential upstream
                    trans.append(nn.Sequential(ConvBN(pre[-1], c, 3, 2)))
            setattr(self, f"transition{idx - 1}", trans)
            setattr(self, f"stage{idx}", nn.Sequential(*(
                HighResolutionModule(stage.num_channels, stage.num_channels,
                                     stage.num_blocks, pallas_conv)
                for _ in range(stage.num_modules))))
            pre = stage.num_channels

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for idx in (2, 3, 4):
            trans = getattr(self, f"transition{idx - 1}")
            xs = [
                (t(xs[i]) if t is not None else xs[i]) if i < len(xs)
                else t(xs[-1])
                for i, t in enumerate(trans)
            ]
            for module in getattr(self, f"stage{idx}"):
                xs = module(xs)
        return xs
