"""K2's plain versions: the small-channel 3x3 convolution and its gradient.

Counterpart of ``contrastiveseg_tpu/ops/conv_pallas.py`` on the port's own
layout: x is NCHW, w is OIHW ``[Co, C, 3, 3]``.  The convolution is 3x3,
stride 1, SAME (zero padding 1), fp32 accumulation, output in x's dtype.

  * ``conv3x3_plain(x, w, flip)``: the forward (``F.conv2d``).  With
    ``flip`` it convolves with w spatially flipped and in/out swapped, which
    is dX of the forward when x is the output gradient (the stride-1
    transposed-conv identity, ``_conv3x3_bwd`` :241-246);
  * ``conv3x3_dw_plain(x, g)``: dW ``[Co, C, 3, 3]`` in fp32;
  * ``supported``/``pick_block_h``: the routing predicate of the JAX package
    (:215, :259), on NCHW shapes;
  * ``Conv3x3``: the differentiable conv over a pair of (forward, dW)
    functions; ``ops/conv_cuda.py`` hands it the CUDA wrappers.

The CPU tests run the plain versions; ``chip_smoke.py`` holds the CUDA
kernels against them on the card.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """3x3 SAME conv of NCHW ``x``; with ``flip``, by ``w`` flipped and
    transposed (``w`` is then ``[C_out_of_the_forward, C, 3, 3]``)."""
    if flip:
        w = w.flip((2, 3)).transpose(0, 1)
    return F.conv2d(x, w.to(x.dtype), padding=1)


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW ``[Co, C, 3, 3]`` fp32 of the 3x3 SAME conv, from x ``[B, C, H, W]``
    and the output gradient g ``[B, Co, H, W]``."""
    shape = (g.shape[1], x.shape[1], 3, 3)
    return torch.nn.grad.conv2d_weight(x.float(), shape, g.float(), padding=1)


def pick_block_h(h: int) -> int:
    """Largest supported row-block size dividing H (0 = unsupported)."""
    for bh in (32, 16, 8):
        if h % bh == 0:
            return bh
    return 0


def supported(x_shape, kernel_size: int, strides: int, dilation: int,
              max_c: int = 64) -> bool:
    """Does a conv of NCHW input ``x_shape`` go through K2?  The JAX
    package's predicate: 3x3, stride 1, undilated, C <= 64, H % 8 == 0."""
    _, c, h, _ = x_shape
    return (kernel_size == 3 and strides == 1 and dilation == 1
            and c <= max_c and pick_block_h(h) > 0)


class ConvOps(NamedTuple):
    fwd: Callable  # (x, w, flip) -> y
    dw: Callable  # (x, g) -> dW fp32


class Conv3x3(torch.autograd.Function):
    """``conv3x3`` with the JAX package's custom VJP: dX is the forward on
    the output gradient with flipped, transposed weights; dW is its own
    function."""

    @staticmethod
    def forward(ctx, x, w, ops: ConvOps):
        ctx.save_for_backward(x, w)
        ctx.ops = ops
        return ops.fwd(x, w, False)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = ctx.ops.fwd(g, w, True) if ctx.needs_input_grad[0] else None
        dw = ctx.ops.dw(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw, None
