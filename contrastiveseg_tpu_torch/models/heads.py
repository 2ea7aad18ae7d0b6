"""Segmentation heads (NCHW).

Counterpart of ``contrastiveseg_tpu/models/heads.py``; slot numbers follow
the upstream torch heads so the ``state_dict`` keys match
``utils/torch_import.py`` (``cls_head.0``, ``cls_head.1.0``, ``cls_head.3``,
``proj_head.proj.{0,1.0,2}``).
"""

from __future__ import annotations

import torch
from torch import nn

from contrastiveseg_tpu_torch.models.layers import TorchBatchNorm, conv


class ClsHead(nn.Sequential):
    """3x3 conv -> BNReLU -> Dropout -> 1x1 conv (no bias) -> logits
    (reference HRNet_W48 cls_head, lib/models/nets/hrnet.py:37-42).  The 3x3
    conv has no bias, like the JAX ConvBN (the upstream bias folds into BN).
    The dropout is element-wise, as in the JAX ``ClsHead``
    (``contrastiveseg_tpu/models/heads.py:29``), not the upstream's
    channel-wise ``Dropout2d``."""

    def __init__(self, in_channels: int, num_classes: int, mid_channels: int,
                 dropout: float = 0.10):
        super().__init__(
            conv(in_channels, mid_channels, 3),
            nn.Sequential(TorchBatchNorm(mid_channels), nn.ReLU()),
            nn.Dropout(dropout),
            conv(mid_channels, num_classes, 1),
        )


class ProjectionHead(nn.Module):
    """convmlp projection (1x1 -> BNReLU -> 1x1) + L2 normalize over channels
    (lib/models/modules/projection.py:8-24)."""

    def __init__(self, dim_in: int, proj_dim: int = 256):
        super().__init__()
        self.proj = nn.Sequential(
            conv(dim_in, dim_in, 1, bias=True),
            nn.Sequential(TorchBatchNorm(dim_in), nn.ReLU()),
            conv(dim_in, proj_dim, 1, bias=True),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.proj(x).float()
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp(min=1e-12)


def bn_relu(channels: int) -> nn.Sequential:
    """BN then ReLU: the reference's ``ModuleHelper.BNReLU``, the JAX
    ``ConvBNAct`` (``models/ocr.py:104-114``); slot ``0`` is the BN."""
    return nn.Sequential(TorchBatchNorm(channels), nn.ReLU())


def conv_bn_relu(in_ch: int, out_ch: int, kernel_size: int, dilation: int = 1,
                 bias: bool = False) -> nn.Sequential:
    """conv -> BNReLU, the reference's ``nn.Sequential(conv,
    ModuleHelper.BNReLU(...))``: slots ``0`` and ``1.0``."""
    return nn.Sequential(conv(in_ch, out_ch, kernel_size, bias=bias, dilation=dilation),
                         bn_relu(out_ch))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling of DeepLab-V3 (JAX ``heads.ASPP``,
    :62-103; the reference's ASPPModule, decoder_block.py:39-85): a 1x1
    branch ``b0``, 3x3 branches ``b1``-``b3`` at rates 12, 24 and 36, and the
    image-pool branch ``b4`` (global mean, 1x1 ConvBNReLU, broadcast back);
    concat, then the 3x3 ``project``.  No dropout, as in the JAX default.

    The image-pool BN normalises B values a channel, so in training it needs
    B >= 2: torch's BN refuses one value, where flax's returns zeros."""

    def __init__(self, in_channels: int, out_channels: int = 512,
                 rates: tuple[int, ...] = (12, 24, 36)):
        super().__init__()
        self.b0 = conv_bn_relu(in_channels, out_channels, 1)
        for i, r in enumerate(rates, 1):
            self.add_module(f"b{i}", conv_bn_relu(in_channels, out_channels, 3, dilation=r))
        self.n_rates = len(rates)
        self.b4 = nn.Sequential(nn.AdaptiveAvgPool2d(1),
                                *conv_bn_relu(in_channels, out_channels, 1))
        self.project = conv_bn_relu((len(rates) + 2) * out_channels, out_channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and x.shape[0] < 2:
            raise ValueError(
                "ASPP's image-pool BatchNorm normalises one value a channel at batch 1 "
                "and cannot train: use train.batch_size >= 2 with DeepLab-V3")
        h, w = x.shape[2], x.shape[3]
        branches = [getattr(self, f"b{i}")(x) for i in range(self.n_rates + 1)]
        branches.append(self.b4(x).expand(-1, -1, h, w))
        return self.project(torch.cat(branches, dim=1))
