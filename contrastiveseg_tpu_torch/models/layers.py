"""Shared building blocks (NCHW, cuDNN convolutions).

Counterpart of ``contrastiveseg_tpu/models/layers.py``.  Module names
follow the upstream torch ``state_dict`` keys (``conv1``/``bn1``,
``downsample.0``/``downsample.1``, ``Sequential`` slots ``.0``/``.1``), the
names that ``contrastiveseg_tpu.utils.torch_import`` maps.

BatchNorm uses torch's defaults (eps 1e-5, momentum 0.1), as the JAX
package does, and updates ``running_var`` with the *biased* batch variance,
as flax does (torch's own BatchNorm uses the unbiased one).  Under a process
group of more than one rank a train-mode BatchNorm normalises with the
statistics of the global batch (``GlobalBatchNorm``), as the JAX package's
global-view step does whatever ``bn_type`` says.

``pallas=True`` routes the eligible 3x3 convs (``ops/conv.supported``)
through K2, the CUDA counterpart of the JAX package's Pallas conv, under
the same parameter names, so weights carry over unchanged.

``network.bf16`` (the JAX nets' ``dtype=jnp.bfloat16``: parameters fp32,
the convolutions, matmuls and activations in bf16) is ``bf16_compute``, a
``torch.autocast`` around a net's forward; the sites that the JAX package
pins to ``jnp.float32`` (the class logits: ``conv(..., fp32=True)``, the
embedding's normalisation, the products of ``preferred_element_type=
jnp.float32`` and their softmax) run under ``full_precision``.  K2 runs in
bf16 there (``PallasConv3x3``).
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from contrastiveseg_tpu_torch.ops.conv import supported
from contrastiveseg_tpu_torch.ops.conv_cuda import conv3x3, traced
from contrastiveseg_tpu_torch.ops.resize import resize_bilinear_half_pixel_nchw
from contrastiveseg_tpu_torch.parallel import all_reduce_sum, world_size

BN_MOMENTUM = 0.1
BN_EPS = 1e-5


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of every rank, in fp32
    (float64 in a float64 run, ``fp32``):
    ``(y, mean, var)`` from ``(x, weight, bias, eps)``, ``var`` biased.

    Two passes, as the exact BN of one process: an all-reduce of each
    channel's sum and count gives the mean, a second one of the sum of
    squared deviations from it the variance (not E[x^2] - E[x]^2, whose
    cancellation a randomly initialised HRNet shows).  The backward
    all-reduces each channel's sum of dy and of dy * x_hat, so that dX is
    the global batch's; dweight and dbias are the rank's own sums, which
    DDP's mean over the ranks makes the global gradient's.  Plain PyTorch:
    ``nn.SyncBatchNorm`` refuses CPU tensors."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        dims = [0, *range(2, x.dim())]
        xf = fp32(x)
        stats = all_reduce_sum(torch.cat([xf.sum(dims), xf.new_full((1,), xf.numel()
                                                                     // xf.shape[1])]))
        n, mean = stats[-1], stats[:-1] / stats[-1]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        xc = xf - mean.view(shape)
        var = all_reduce_sum((xc * xc).sum(dims)) / n
        invstd = torch.rsqrt(var + eps)
        y = xc * invstd.view(shape)
        if weight is not None:
            y = y * weight.view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.mark_non_differentiable(mean, var)
        return y.to(x.dtype), mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims = [0, *range(2, x.dim())]
        shape = (1, -1) + (1,) * (x.dim() - 2)
        dyf = fp32(dy)
        x_hat = (fp32(x) - mean.view(shape)) * invstd.view(shape)
        local = torch.cat([dyf.sum(dims), (dyf * x_hat).sum(dims)])
        sum_dy, sum_dy_xhat = all_reduce_sum(local).chunk(2)
        scale = invstd if weight is None else invstd * weight
        dx = scale.view(shape) * (dyf - (sum_dy / n).view(shape)
                                  - x_hat * (sum_dy_xhat / n).view(shape))
        d_bias, d_weight = local.chunk(2)
        if weight is None:
            d_weight = d_bias = None
        return dx.to(x.dtype), d_weight, d_bias, None


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose running variance takes the biased batch
    variance, as flax's does, and whose train-mode statistics are the
    global batch's under more than one rank (``GlobalBatchNorm``).

    cuDNN's batch norm updates ``running_var`` with the unbiased variance
    n/(n-1)·v, n = B·H·W.  Scaling the buffer by n/(n-1) before the call and
    by (n-1)/n after gives (1-m)·rv + m·v exactly: two in-place multiplies
    of a C-length buffer, no extra pass over the activations.  They go
    through ``.data``: the op records ``running_var`` for its backward,
    which in train mode never reads it, and a version bump would fail it.
    Eval mode, ``freeze_bn`` (eval mode too) and one rank keep that call.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        if world_size() > 1:
            return self._global_forward(x)
        n = x.numel() // x.shape[1]
        self.running_var.data.mul_(n / (n - 1))
        out = super().forward(x)
        self.running_var.data.mul_((n - 1) / n)
        return out

    def _global_forward(self, x: torch.Tensor) -> torch.Tensor:
        y, mean, var = GlobalBatchNorm.apply(x, self.weight, self.bias, self.eps)
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
            m = (self.momentum if self.momentum is not None
                 else 1.0 / float(self.num_batches_tracked))  # swa.reestimate_bn
            self.running_mean.lerp_(mean, m)
            self.running_var.lerp_(var, m)
        return y


def bf16_compute(enabled: bool, x: torch.Tensor):
    """The block of a net built with ``network.bf16`` that computes in bf16:
    ``torch.autocast`` to bf16 on ``x``'s device; a no-op when not
    ``enabled``."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, dtype=torch.bfloat16)


def full_precision(x: torch.Tensor):
    """A block computed in fp32 inside ``bf16_compute`` (a JAX
    ``jnp.float32`` site); a no-op outside one, so fp32 nets trace as
    before."""
    if not torch.is_autocast_enabled(x.device.type):
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, enabled=False)


def fp32(t: torch.Tensor) -> torch.Tensor:
    """``t`` upcast to fp32 from a 16-bit float type (an operand of a product
    that the JAX package takes in fp32 in its bf16 nets); as it is in an
    fp32 or float64 run."""
    return t.float() if t.is_floating_point() and t.element_size() < 4 else t


class Float32Conv2d(nn.Conv2d):
    """A conv that the JAX package keeps in fp32 in its bf16 nets
    (``nn.Conv(..., dtype=jnp.float32)(x.astype(jnp.float32))``: the class
    logits), in its parameters' dtype; an ``nn.Conv2d`` otherwise."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with full_precision(x):
            return super().forward(x.to(self.weight.dtype))


def TorchBatchNorm(channels: int) -> BatchNorm2d:  # noqa: N802 (mirrors the JAX class)
    return BatchNorm2d(channels, eps=BN_EPS, momentum=BN_MOMENTUM)


class PallasConv3x3(nn.Conv2d):
    """Counterpart of the JAX ``PallasConv3x3``: a bias-free conv whose
    forward goes through K2 (``ops/conv_cuda.conv3x3``) when
    ``supported()`` holds for its input, the JAX package's predicate (3x3,
    stride 1, undilated, C <= 64, H % 8 == 0), and through cuDNN otherwise.
    The parameter is the usual ``weight``.  Inside ``bf16_compute`` the
    input is cast to the autocast dtype before K2, and the weight is
    rounded to it, as the JAX layer casts both to its ``dtype``
    (``layers.py:67-68``): autocast does not reach K2.  Eagerly, K2 takes
    the fp32 weight and rounds it to bf16 as it loads it, and returns dW
    rounded to bf16 in fp32 to the parameter (no cast launches); traced for
    export, the weight is cast here and the custom op computes in its
    dtype, with the same numbers."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not supported(x.shape, self.kernel_size[0], self.stride[0], self.dilation[0]):
            return super().forward(x)
        w = self.weight
        if torch.is_autocast_enabled(x.device.type):
            dtype = torch.get_autocast_dtype(x.device.type)
            x = x.to(dtype)
            if dtype != torch.bfloat16 or traced(x):
                w = w.to(dtype)
        return conv3x3(x, w)


def conv(in_ch: int, out_ch: int, kernel_size: int, stride: int = 1,
         bias: bool = False, pallas: bool = False, dilation: int = 1,
         zero_init: bool = False, fp32: bool = False) -> nn.Conv2d:
    """Padding ``dilation * (k - 1) // 2`` on both sides, as the JAX
    ``ConvBN`` pads (``models/layers.py:104-112``): not XLA's "SAME", which
    pads a strided even-sized input asymmetrically.  ``zero_init``: the
    weight starts at 0 (a flax ``kernel_init=zeros``), and
    ``engine/state.init_weights`` keeps it there.  ``fp32``: a
    ``Float32Conv2d``."""
    cls = (Float32Conv2d if fp32 else
           PallasConv3x3 if pallas and not bias else nn.Conv2d)
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
