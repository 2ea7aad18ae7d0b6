"""K2 on the card: the small-channel 3x3 convolution as hand-written CUDA.

Replaces the Pallas kernels of ``contrastiveseg_tpu/ops/conv_pallas.py``
(``_conv3x3_kernel`` :55, ``_conv3x3_dw_kernel`` :141) in both dtypes the
JAX package runs them in: fp32, and bf16 operands with fp32 accumulation
(a net built with ``network.bf16``).  The kernels and their design notes
are in ``csrc/conv3x3.cu``, built by ``ops/cuda_lib.py``.

Each wrapper (``conv3x3_fwd``, ``conv3x3_dw``):
  * takes the plain version in ``ops/conv.py`` for CPU tensors, and only
    for those;
  * for CUDA tensors dispatches on the dtype (fp32 to ``conv3x3_fwd`` /
    ``conv3x3_dw``, bf16 to ``conv3x3_fwd_bf16`` / ``conv3x3_dw_bf16``, any
    other raises), checks device, shape and contiguity, allocates its
    outputs and dW's split partials with ``torch.empty``, launches on the
    current stream and raises if ``cudaGetLastError()`` is not 0;
  * counts each kernel's launches apart (``launch_counts()``: one row per
    kernel and dtype).

``conv3x3(x, w)`` is the differentiable conv: the custom op
``contrastiveseg::conv3x3`` (``torch.library.custom_op``) with a CUDA
implementation through the wrappers, a CPU one that is the plain version, a
fake one for shapes (so ``torch.export`` traces a net that runs K2), and the
JAX package's VJP (``_conv3x3_bwd`` :241-253): dX is the forward on the
output gradient with flipped, transposed weights, dW the op
``contrastiveseg::conv3x3_dw`` rounded to the weights' dtype (bf16 in a
bf16 net, as the JAX VJP's ``dw.astype(w.dtype)``).
"""

from __future__ import annotations

import torch

from contrastiveseg_tpu_torch.ops import cuda_lib
from contrastiveseg_tpu_torch.ops.conv import conv3x3_dw_plain, conv3x3_plain
from contrastiveseg_tpu_torch.ops.cuda_lib import I, P, check, ptrs, stream

LIBRARY = cuda_lib.CudaLibrary(
    "conv3x3.cu",
    {"conv3x3_fwd": [P, P, P, I, I, I, I, I, I, P],
     "conv3x3_dw": [P, P, P, P, I, I, I, I, I, I, P],
     "conv3x3_fwd_bf16": [P, P, P, I, I, I, I, I, I, P],
     "conv3x3_dw_bf16": [P, P, P, P, I, I, I, I, I, I, P]},
    error_string="conv3x3_error_string", init="conv3x3_init")
_DW_SW = 128  # pixels per dW row segment (csrc DW_SW)
_DW_CO = 16  # output channels per dW block (csrc DW_CO)
_DW_MAX_C = 64  # input channels of dW, at most (csrc DW_MAX_C)
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16"}


def dw_splits(B: int, C: int, Co: int, H: int, W: int, device: torch.device) -> int:
    """Row-segment splits of dW: (splits x 16-channel output blocks) fills
    the card about once, one block per SM."""
    blocks = -(-Co // _DW_CO)
    n_units = B * H * -(-W // _DW_SW)
    return max(1, min(n_units, cuda_lib.sm_count(device.index) // blocks))


def _kernel(base: str, x: torch.Tensor) -> str:
    """The entry point of ``base`` for ``x``'s dtype."""
    if x.dtype not in _SUFFIX:
        raise ValueError(f"K2 takes fp32 or bf16 tensors, got dtype {x.dtype}")
    return base + _SUFFIX[x.dtype]


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """K2a: 3x3 SAME conv of NCHW ``x`` by OIHW ``w`` of the same dtype, fp32
    or bf16 (``flip``: by ``w`` flipped and transposed, dX of the forward);
    the output in that dtype."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, flip)
    dev = cuda_lib.require_cuda("K2", x)
    if x.dim() != 4:
        raise ValueError(f"K2 takes NCHW input, got shape {tuple(x.shape)}")
    name = _kernel("conv3x3_fwd", x)
    B, C, H, W = x.shape
    Co = w.shape[1] if flip else w.shape[0]
    check("x", x, x.dtype, (B, C, H, W), dev)
    check("w", w, x.dtype, (C, Co, 3, 3) if flip else (Co, C, 3, 3), dev)
    y = torch.empty((B, Co, H, W), dtype=x.dtype, device=dev)
    LIBRARY.launch(name, dev, *ptrs(x, w, y), B, C, Co, H, W, int(flip), stream(dev))
    _LAUNCHES[name] += 1
    return y


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """K2b: dW ``[Co, C, 3, 3]`` in fp32 from NCHW ``x`` and output gradient
    ``g`` of the same dtype, fp32 or bf16."""
    if x.device.type == "cpu":
        return conv3x3_dw_plain(x, g)
    dev = cuda_lib.require_cuda("K2", x)
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"K2 takes NCHW tensors, got {tuple(x.shape)} and {tuple(g.shape)}")
    name = _kernel("conv3x3_dw", x)
    B, C, H, W = x.shape
    Co = g.shape[1]
    check("x", x, x.dtype, (B, C, H, W), dev)
    check("g", g, x.dtype, (B, Co, H, W), dev)
    if C > _DW_MAX_C:
        raise ValueError(f"K2b supports C <= {_DW_MAX_C} input channels, got {C}")
    S = dw_splits(B, C, Co, H, W, dev)
    part = torch.empty((S, Co, C, 3, 3), dtype=torch.float32, device=dev)
    dw = torch.empty((Co, C, 3, 3), dtype=torch.float32, device=dev)
    LIBRARY.launch(name, dev, *ptrs(x, g, part, dw), B, C, Co, H, W, S, stream(dev))
    _LAUNCHES[name] += 1
    return dw


# (wrapper, plain version, TPU kernel it replaces) for each kernel of K2, by dtype.
KERNELS = {
    "conv3x3_fwd": (conv3x3_fwd, conv3x3_plain, "contrastiveseg_tpu/ops/conv_pallas.py:55"),
    "conv3x3_dw": (conv3x3_dw, conv3x3_dw_plain, "contrastiveseg_tpu/ops/conv_pallas.py:141"),
    "conv3x3_fwd_bf16": (conv3x3_fwd, conv3x3_plain,
                         "contrastiveseg_tpu/ops/conv_pallas.py:55"),
    "conv3x3_dw_bf16": (conv3x3_dw, conv3x3_dw_plain,
                        "contrastiveseg_tpu/ops/conv_pallas.py:141"),
}
_LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


@torch.library.custom_op("contrastiveseg::conv3x3", mutates_args=(), device_types="cuda")
def conv3x3_op(x: torch.Tensor, w: torch.Tensor, flip: bool) -> torch.Tensor:
    # An exported graph may hand the op a tensor of other strides than eager
    # code did (torch.export drops the caller's no-op .contiguous()).
    return conv3x3_fwd(x.contiguous(), w.contiguous(), flip)


@torch.library.custom_op("contrastiveseg::conv3x3_dw", mutates_args=(), device_types="cuda")
def conv3x3_dw_op(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    return conv3x3_dw(x.contiguous(), g.contiguous())


conv3x3_op.register_kernel("cpu")(conv3x3_plain)
conv3x3_dw_op.register_kernel("cpu")(conv3x3_dw_plain)


@conv3x3_op.register_fake
def _conv3x3_fake(x, w, flip):
    return x.new_empty((x.shape[0], w.shape[1] if flip else w.shape[0], *x.shape[2:]))


@conv3x3_dw_op.register_fake
def _conv3x3_dw_fake(x, g):
    return x.new_empty((g.shape[1], x.shape[1], 3, 3), dtype=torch.float32)


def _setup_context(ctx, inputs, output):
    x, w, flip = inputs
    ctx.flip = flip
    ctx.save_for_backward(x, w)


def _backward(ctx, g):
    if ctx.flip:
        raise NotImplementedError("K2's dX (flip=True) has no gradient of its own")
    x, w = ctx.saved_tensors
    g = g.contiguous()
    dx = conv3x3_op(g, w, True) if ctx.needs_input_grad[0] else None
    dw = conv3x3_dw_op(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
    return dx, dw, None


conv3x3_op.register_autograd(_backward, setup_context=_setup_context)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable 3x3 SAME conv (stride 1, NCHW, OIHW) through K2."""
    return conv3x3_op(x, w, False)
