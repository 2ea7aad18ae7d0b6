"""K2's plain versions: the small-channel 3x3 convolution and its gradient.

Counterpart of ``contrastiveseg_tpu/ops/conv_pallas.py`` on the port's own
layout: x is NCHW, w is OIHW ``[Co, C, 3, 3]``.  The convolution is 3x3,
stride 1, SAME (zero padding 1), fp32 accumulation, output in x's dtype,
fp32 or bf16 (the JAX kernel's arithmetic in a bf16 net: bf16 operands, fp32
sums, the output rounded once to bf16).

  * ``conv3x3_plain(x, w, flip)``: the forward, ``F.conv2d`` on the fp32
    upcasts of bf16 operands, rounded once to x's dtype (fp32 and fp64 as
    they are).  With ``flip`` it
    convolves with w spatially flipped and in/out swapped, which is dX of
    the forward when x is the output gradient (the stride-1 transposed-conv
    identity, ``_conv3x3_bwd`` :241-246);
  * ``conv3x3_dw_plain(x, g)``: dW ``[Co, C, 3, 3]`` in fp32 from the fp32
    upcasts (products of bf16 values are exact in fp32);
  * ``supported``/``pick_block_h``: the routing predicate of the JAX package
    (:215, :259), on NCHW shapes.

Both run in fp32 whatever ``torch.autocast`` is active, so the backend
never picks the accumulation precision.  The CPU tests run the plain
versions; ``chip_smoke.py`` holds the CUDA kernels of ``ops/conv_cuda.py``
against them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """3x3 SAME conv of NCHW ``x``; with ``flip``, by ``w`` flipped and
    transposed (``w`` is then ``[C_out_of_the_forward, C, 3, 3]``)."""
    if flip:
        w = w.flip((2, 3)).transpose(0, 1)
    wide = x.float() if x.element_size() < 4 else x  # a 16-bit x: fp32 sums
    with torch.autocast(x.device.type, enabled=False):
        return F.conv2d(wide, w.to(wide.dtype), padding=1).to(x.dtype)


def conv3x3_dw_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dW ``[Co, C, 3, 3]`` fp32 of the 3x3 SAME conv, from x ``[B, C, H, W]``
    and the output gradient g ``[B, Co, H, W]``."""
    shape = (g.shape[1], x.shape[1], 3, 3)
    with torch.autocast(x.device.type, enabled=False):
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
