"""Shared building blocks (NCHW, cuDNN convolutions).

Counterpart of ``contrastiveseg_tpu/models/layers.py``.  Module names
follow the upstream torch ``state_dict`` keys (``conv1``/``bn1``,
``downsample.0``/``downsample.1``, ``Sequential`` slots ``.0``/``.1``), the
names that ``contrastiveseg_tpu.utils.torch_import`` maps.

BatchNorm uses torch's defaults (eps 1e-5, momentum 0.1), as the JAX
package does, and updates ``running_var`` with the *biased* batch variance,
as flax does (torch's own BatchNorm uses the unbiased one).

``pallas=True`` routes the eligible 3x3 convs (``ops/conv.supported``)
through K2, the CUDA counterpart of the JAX package's Pallas conv, under
the same parameter names, so weights carry over unchanged.
"""

from __future__ import annotations

import torch
from torch import nn

from contrastiveseg_tpu_torch.ops.conv import supported
from contrastiveseg_tpu_torch.ops.conv_cuda import conv3x3
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_half_pixel_nchw

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance takes the biased batch
    variance, as flax's does.

    cuDNN's batch norm updates ``running_var`` with the unbiased variance
    n/(n-1)·v, n = B·H·W.  Scaling the buffer by n/(n-1) before the call and
    by (n-1)/n after gives (1-m)·rv + m·v exactly: two in-place multiplies
    of a C-length buffer, no extra pass over the activations.  They go
    through ``.data``: the op records ``running_var`` for its backward,
    which in train mode never reads it, and a version bump would fail it.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        n = x.numel() // x.shape[1]
        self.running_var.data.mul_(n / (n - 1))
        out = super().forward(x)
        self.running_var.data.mul_((n - 1) / n)
        return out


def TorchBatchNorm(channels: int) -> BatchNorm2d:  # noqa: N802 (mirrors the JAX class)
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class PallasConv3x3(nn.Conv2d):
    """Counterpart of the JAX ``PallasConv3x3``: a bias-free conv whose
    forward goes through K2 (``ops/conv_cuda.conv3x3``) when
    ``supported()`` holds for its input, the JAX package's predicate (3x3,
    stride 1, undilated, C <= 64, H % 8 == 0), and through cuDNN otherwise.
    The parameter is the usual ``weight``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if supported(x.shape, self.kernel_size[0], self.stride[0], self.dilation[0]):
            return conv3x3(x.contiguous(), self.weight)
        return super().forward(x)


def conv(in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
         bias: bool = False, pallas: bool = False, dilation: int = 1,
         zero_init: bool = False) -> nn.Conv2d:
    """Padding ``dilation * (k - 1) // 2`` on both sides, as the JAX
    ``ConvBN`` pads (``models/layers.py:104-112``): not XLA's "SAME", which
    pads a strided even-sized input asymmetrically.  ``zero_init``: the
    weight starts at 0 (a flax ``kernel_init=zeros``), and
    ``engine/state.init_weights`` keeps it there."""
    cls = PallasConv3x3 if pallas and not bias else nn.Conv2d
    out = cls(in_ch, out_ch, kernel_size, stride=stride,
              padding=dilation * (kernel_size - 1) // 2, dilation=dilation, bias=bias)
    if zero_init:
        out.zero_init = True
        nn.init.zeros_(out.weight)
        if bias:
            nn.init.zeros_(out.bias)
    return out


class ConvBN(nn.Sequential):
    """Conv2d (no bias) -> BN [-> ReLU]; state_dict slots ``0`` and ``1``."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, use_relu: bool = True, pallas: bool = False,
                 dilation: int = 1):
        layers = [conv(in_ch, out_ch, kernel_size, stride, pallas=pallas,
                       dilation=dilation),
                  TorchBatchNorm(out_ch)]
        if use_relu:
            layers.append(nn.ReLU())
        super().__init__(*layers)


class BasicBlock(nn.Module):
    """HRNet/ResNet basic residual block (3x3, 3x3), expansion 1
    (hrnet_backbone.py:35-66); both 3x3 convs at ``dilation``, as in the JAX
    ``BasicBlock``."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, pallas: bool = False, dilation: int = 1):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 3, stride, pallas=pallas, dilation=dilation)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, pallas=pallas, dilation=dilation)
        self.bn2 = TorchBatchNorm(planes)
        self.relu = nn.ReLU()
        self.downsample = (ConvBN(inplanes, planes, 1, stride, use_relu=False)
                           if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return self.relu(out + residual)


class Bottleneck(nn.Module):
    """Bottleneck residual block (1x1, 3x3, 1x1 x4), expansion 4
    (hrnet_backbone.py:68-106; resnet_models.py Bottleneck); the 3x3 at
    ``dilation``."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dilation: int = 1):
        super().__init__()
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = TorchBatchNorm(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation=dilation)
        self.bn2 = TorchBatchNorm(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = TorchBatchNorm(planes * 4)
        self.relu = nn.ReLU()
        self.downsample = (ConvBN(inplanes, planes * 4, 1, stride,
                                  use_relu=False) if downsample else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return self.relu(out + residual)


class Upsample(nn.Module):
    """x ``factor`` half-pixel bilinear upsample of an NCHW map (the
    reference's ``nn.Upsample(scale_factor, mode="bilinear")``, align_corners
    False; JAX ``resize_bilinear_half_pixel``)."""

    def __init__(self, factor: int):
        super().__init__()
        self.factor = factor

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return resize_bilinear_half_pixel_nchw(
            x, (x.shape[2] * self.factor, x.shape[3] * self.factor))
