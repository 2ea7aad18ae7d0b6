"""K2 on the card: the small-channel 3x3 convolution as hand-written CUDA.

Replaces the Pallas kernels of ``contrastiveseg_tpu/ops/conv_pallas.py``
(``_conv3x3_kernel`` :55, ``_conv3x3_dw_kernel`` :141); the kernels and
their design notes are in ``csrc/conv3x3.cu``, built by ``ops/cuda_lib.py``.

Each wrapper (``conv3x3_fwd``, ``conv3x3_dw``):
  * takes the plain version in ``ops/conv.py`` for CPU tensors, and only
    for those;
  * for CUDA tensors checks device, dtype (fp32), shape and contiguity,
    allocates its outputs and dW's split partials with ``torch.empty``,
    launches on the current stream and raises if ``cudaGetLastError()`` is
    not 0;
  * counts its launches in ``<wrapper>.launches``.

``conv3x3(x, w)`` is the differentiable conv over the two: forward and dX
through ``conv3x3_fwd``, dW through ``conv3x3_dw``.
"""

from __future__ import annotations

import torch

from contrastiveseg_tpu_torch.ops import cuda_lib
from contrastiveseg_tpu_torch.ops.conv import (
    Conv3x3,
    ConvOps,
    conv3x3_dw_plain,
    conv3x3_plain,
)
from contrastiveseg_tpu_torch.ops.cuda_lib import I, P, check, ptrs, stream

LIBRARY = cuda_lib.CudaLibrary(
    "conv3x3.cu",
    {"conv3x3_fwd": [P, P, P, I, I, I, I, I, I, P],
     "conv3x3_dw": [P, P, P, P, I, I, I, I, I, I, P]},
    error_string="conv3x3_error_string", init="conv3x3_init")
_DW_SW = 128  # pixels per dW row segment (csrc DW_SW)
_DW_CO = 16  # output channels per dW block (csrc DW_CO)
_DW_MAX_C = 64  # input channels of dW, at most (csrc DW_MAX_C)


def dw_splits(B: int, C: int, Co: int, H: int, W: int, device: torch.device) -> int:
    """Row-segment splits of dW: (splits x 16-channel output blocks) fills
    the card about once, one block per SM."""
    blocks = -(-Co // _DW_CO)
    n_units = B * H * -(-W // _DW_SW)
    return max(1, min(n_units, cuda_lib.sm_count(device.index) // blocks))


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """K2a: 3x3 SAME conv of NCHW fp32 ``x`` by OIHW ``w`` (``flip``: by ``w``
    flipped and transposed, dX of the forward)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, flip)
    dev = cuda_lib.require_cuda("K2", x)
    if x.dim() != 4:
        raise ValueError(f"K2 takes NCHW input, got shape {tuple(x.shape)}")
    B, C, H, W = x.shape
    Co = w.shape[1] if flip else w.shape[0]
    check("x", x, torch.float32, (B, C, H, W), dev)
    check("w", w, torch.float32, (C, Co, 3, 3) if flip else (Co, C, 3, 3), dev)
    y = torch.empty((B, Co, H, W), dtype=torch.float32, device=dev)
    LIBRARY.launch("conv3x3_fwd", dev, *ptrs(x, w, y), B, C, Co, H, W, int(flip),
                   stream(dev))
    conv3x3_fwd.launches += 1
    return y


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2b: dW ``[Co, C, 3, 3]`` fp32 from NCHW ``x`` and output gradient ``g``."""
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, g)
    dev = cuda_lib.require_cuda("K2", x)
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"K2 takes NCHW tensors, got {tuple(x.shape)} and {tuple(g.shape)}")
    B, C, H, W = x.shape
    Co = g.shape[1]
    check("x", x, torch.float32, (B, C, H, W), dev)
    check("g", g, torch.float32, (B, Co, H, W), dev)
    if C > _DW_MAX_C:
        raise ValueError(f"K2b supports C <= {_DW_MAX_C} input channels, got {C}")
    S = dw_splits(B, C, Co, H, W, dev)
    part = torch.empty((S, Co, C, 3, 3), dtype=torch.float32, device=dev)
    dw = torch.empty((Co, C, 3, 3), dtype=torch.float32, device=dev)
    LIBRARY.launch("conv3x3_dw", dev, *ptrs(x, g, part, dw), B, C, Co, H, W, S,
                   stream(dev))
    conv3x3_dw.launches += 1
    return dw


conv3x3_fwd.launches = 0
conv3x3_dw.launches = 0

CUDA_OPS = ConvOps(conv3x3_fwd, conv3x3_dw)

# (wrapper, plain version, TPU kernel it replaces) for each kernel of K2.
KERNELS = {
    "conv3x3_fwd": (conv3x3_fwd, conv3x3_plain,
                    "contrastiveseg_tpu/ops/conv_pallas.py:55"),
    "conv3x3_dw": (conv3x3_dw, conv3x3_dw_plain,
                   "contrastiveseg_tpu/ops/conv_pallas.py:141"),
}


def reset_launch_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable 3x3 SAME conv (stride 1, NCHW, OIHW) through K2."""
    return Conv3x3.apply(x, w, CUDA_OPS)
