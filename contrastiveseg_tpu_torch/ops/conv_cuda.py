"""K2 on the card: the small-channel 3x3 convolution as hand-written CUDA.

Replaces the Pallas kernels of ``contrastiveseg_tpu/ops/conv_pallas.py``
(``_conv3x3_kernel`` :55, ``_conv3x3_dw_kernel`` :141) in both dtypes the
JAX package runs them in: fp32, and bf16 operands with fp32 accumulation
(a net built with ``network.bf16``).  The kernels and their design notes
are in ``csrc/conv3x3.cu``, built by ``ops/cuda_lib.py``.

Each wrapper (``conv3x3_fwd``, ``conv3x3_dw``):
  * takes the plain version in ``ops/conv.py`` for CPU tensors, and only
    for those;
  * for CUDA tensors dispatches on the dtype and the shape: fp32 to
    ``conv3x3_fwd`` / ``conv3x3_dw``; bf16 to the TMA and wgmma kernels
    (``conv3x3_fwd_bf16_tma`` / ``conv3x3_dw_bf16_tma``) where TMA can take
    the tensors (``tma_route``: W % 8 == 0, C and Co <= 64, 16-byte aligned
    bases), else to PR 16's ``conv3x3_fwd_bf16`` / ``conv3x3_dw_bf16``; any
    other dtype raises.  It checks device, shape and contiguity, allocates
    its outputs and dW's split partials with ``torch.empty``, launches on
    the current stream and raises if the entry point returns non-zero;
  * counts each kernel's launches apart (``launch_counts()``: one row per
    kernel, dtype and route).

A bf16 forward or dX takes its weights in bf16, or in fp32, which the TMA
kernel rounds to bf16 as it loads them (``w.to(torch.bfloat16)``'s
rounding): a bf16 net's fp32 parameter needs no cast launch a call.

``conv3x3(x, w)`` is the differentiable conv, with the JAX package's VJP
(``_conv3x3_bwd`` :241-253): dX is the forward on the output gradient with
flipped, transposed weights; dW is rounded to the weights' dtype (bf16 in
a bf16 net, as the JAX VJP's ``dw.astype(w.dtype)``), and for bf16 x with
fp32 weights rounded to bf16 and kept in fp32 (the gradient that the cast
of the fp32 weight to bf16 would pass back).  Called eagerly it is
``Conv3x3``, a ``torch.autograd.Function`` whose forward and backward call
the wrappers directly; traced (``torch.export``, ``torch.compile``) it is
the custom op ``contrastiveseg::conv3x3`` (``torch.library.custom_op``,
with a CUDA implementation through the wrappers, a CPU one that is the
plain version and a fake one for shapes), so an exported net calls K2.
Both routes launch the same kernels.
"""

from __future__ import annotations

import torch

from contrastiveseg_tpu_torch.ops import cuda_lib
from contrastiveseg_tpu_torch.ops.conv import conv3x3_dw_plain, conv3x3_plain
from contrastiveseg_tpu_torch.ops.cuda_lib import I, P, check, stream

LIBRARY = cuda_lib.CudaLibrary(
    "conv3x3.cu",
    {"conv3x3_fwd": [P, P, P, I, I, I, I, I, I, P],
     "conv3x3_dw": [P, P, P, P, I, I, I, I, I, I, P],
     "conv3x3_fwd_bf16": [P, P, P, I, I, I, I, I, I, P],
     "conv3x3_dw_bf16": [P, P, P, P, I, I, I, I, I, I, P],
     "conv3x3_fwd_bf16_tma": [P, P, I, P, I, I, I, I, I, I, I, P],
     "conv3x3_dw_bf16_tma": [P, P, P, P, I, I, I, I, I, I, I, P]},
    error_string="conv3x3_error_string", init="conv3x3_init")
_DW_SW = 128  # pixels per dW row segment of the fp32 and ragged bf16 kernels (csrc DW_SW)
_DW_CO = 16  # output channels per dW block of those (csrc DW_CO)
_DW_MAX_C = 64  # input channels of dW, at most (csrc DW_MAX_C)
_TMA_W = 64  # pixels per row segment of the TMA kernels (csrc TB_W)
_TMA_MAX_C = 64  # input and output channels of the TMA kernels, at most
_BF16, _FP32 = torch.bfloat16, torch.float32


def dw_splits(B: int, C: int, Co: int, H: int, W: int, device: torch.device) -> int:
    """Row-segment splits of the fp32 and ragged bf16 dW: (splits x
    16-channel output blocks) fills the card about once, one block per SM."""
    blocks = -(-Co // _DW_CO)
    n_units = B * H * -(-W // _DW_SW)
    return max(1, min(n_units, cuda_lib.sm_count(device.index) // blocks))


def tma_splits(B: int, H: int, W: int, device: torch.device) -> int:
    """Blocks (= splits) of the TMA dW: at most one an SM, each
    ceil(n_units / splits) row segments of 64 pixels."""
    n_units = B * H * -(-W // _TMA_W)
    per = -(-n_units // min(n_units, cuda_lib.sm_count(device.index)))
    return -(-n_units // per)


def tma_route(x: torch.Tensor, C: int, Co: int, *others: torch.Tensor) -> bool:
    """Do the TMA kernels take these tensors?  TMA rows are a multiple of
    16 bytes (W % 8 == 0 in bf16) and start 16-byte aligned; the kernels
    hold at most 64 channels a side."""
    return (x.shape[3] % 8 == 0 and C <= _TMA_MAX_C and Co <= _TMA_MAX_C
            and all(t.data_ptr() % 16 == 0 for t in (x, *others)))


def conv3x3_fwd(x: torch.Tensor, w: torch.Tensor, flip: bool = False) -> torch.Tensor:
    """K2a: 3x3 SAME conv of NCHW ``x`` by OIHW ``w`` (``flip``: by ``w``
    flipped and transposed, dX of the forward); the output in x's dtype.
    fp32 x takes fp32 ``w``; bf16 x takes bf16 ``w``, or fp32 ``w`` rounded
    to bf16."""
    if x.device.type == "cpu":
        if x.dtype == _BF16 and w.dtype == _FP32:
            w = w.to(_BF16)
        return conv3x3_plain(x, w, flip)
    dev = cuda_lib.require_cuda("K2", x)
    if x.dim() != 4:
        raise ValueError(f"K2 takes NCHW input, got shape {tuple(x.shape)}")
    B, C, H, W = x.shape
    Co = w.shape[1] if flip else w.shape[0]
    check("x", x, (_FP32, _BF16), (B, C, H, W), dev)
    bf16 = x.dtype == _BF16
    check("w", w, (_BF16, _FP32) if bf16 else _FP32, (C, Co, 3, 3) if flip else (Co, C, 3, 3),
          dev)
    y = torch.empty((B, Co, H, W), dtype=x.dtype, device=dev)
    if not bf16:
        name = "conv3x3_fwd"
        LIBRARY.launch(name, dev, x.data_ptr(), w.data_ptr(), y.data_ptr(), B, C, Co, H, W,
                       int(flip), stream(dev))
    elif tma_route(x, C, Co):
        name = "conv3x3_fwd_bf16"
        LIBRARY.launch("conv3x3_fwd_bf16_tma", dev, x.data_ptr(), w.data_ptr(),
                       int(w.dtype == _FP32), y.data_ptr(), B, C, Co, H, W, int(flip),
                       cuda_lib.sm_count(dev.index), stream(dev))
    else:
        name = "conv3x3_fwd_bf16_ragged"
        w = w.to(_BF16)
        LIBRARY.launch("conv3x3_fwd_bf16", dev, x.data_ptr(), w.data_ptr(), y.data_ptr(), B, C,
                       Co, H, W, int(flip), stream(dev))
    _LAUNCHES[name] += 1
    return y


def conv3x3_dw(x: torch.Tensor, g: torch.Tensor, round_bf16: bool = False) -> torch.Tensor:
    """K2b: dW ``[Co, C, 3, 3]`` in fp32 from NCHW ``x`` and output gradient
    ``g`` of the same dtype, fp32 or bf16; with ``round_bf16`` each value
    rounded to bf16 (and kept in fp32)."""
    if x.device.type == "cpu":
        dw = conv3x3_dw_plain(x, g)
        return dw.to(_BF16).float() if round_bf16 else dw
    dev = cuda_lib.require_cuda("K2", x)
    if x.dim() != 4 or g.dim() != 4:
        raise ValueError(f"K2 takes NCHW tensors, got {tuple(x.shape)} and {tuple(g.shape)}")
    B, C, H, W = x.shape
    Co = g.shape[1]
    check("x", x, (_FP32, _BF16), (B, C, H, W), dev)
    check("g", g, x.dtype, (B, Co, H, W), dev)
    if C > _DW_MAX_C:
        raise ValueError(f"K2b supports C <= {_DW_MAX_C} input channels, got {C}")
    dw = torch.empty((Co, C, 3, 3), dtype=_FP32, device=dev)
    if x.dtype == _BF16 and tma_route(x, C, Co, g):
        name = "conv3x3_dw_bf16"
        S = tma_splits(B, H, W, dev)
        part = torch.empty((S, 9, Co, C), dtype=_FP32, device=dev)
        LIBRARY.launch("conv3x3_dw_bf16_tma", dev, x.data_ptr(), g.data_ptr(), part.data_ptr(),
                       dw.data_ptr(), B, C, Co, H, W, S, int(round_bf16), stream(dev))
        _LAUNCHES[name] += 1
        return dw
    name = "conv3x3_dw_bf16_ragged" if x.dtype == _BF16 else "conv3x3_dw"
    S = dw_splits(B, C, Co, H, W, dev)
    part = torch.empty((S, Co, C, 3, 3), dtype=_FP32, device=dev)
    LIBRARY.launch("conv3x3_dw_bf16" if x.dtype == _BF16 else "conv3x3_dw", dev, x.data_ptr(),
                   g.data_ptr(), part.data_ptr(), dw.data_ptr(), B, C, Co, H, W, S, stream(dev))
    _LAUNCHES[name] += 1
    return dw.to(_BF16).float() if round_bf16 else dw


_PALLAS = "contrastiveseg_tpu/ops/conv_pallas.py"
# (wrapper, plain version, TPU kernel it replaces) for each kernel of K2, by dtype
# and route: the bf16 rows are the TMA and wgmma kernels, the "_ragged" rows PR 16's
# kernels, which take the shapes TMA cannot (``tma_route``).
KERNELS = {
    "conv3x3_fwd": (conv3x3_fwd, conv3x3_plain, f"{_PALLAS}:55"),
    "conv3x3_dw": (conv3x3_dw, conv3x3_dw_plain, f"{_PALLAS}:141"),
    "conv3x3_fwd_bf16": (conv3x3_fwd, conv3x3_plain, f"{_PALLAS}:55"),
    "conv3x3_dw_bf16": (conv3x3_dw, conv3x3_dw_plain, f"{_PALLAS}:141"),
    "conv3x3_fwd_bf16_ragged": (conv3x3_fwd, conv3x3_plain, f"{_PALLAS}:55"),
    "conv3x3_dw_bf16_ragged": (conv3x3_dw, conv3x3_dw_plain, f"{_PALLAS}:141"),
}
_LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def launch_counts() -> dict[str, int]:
    return dict(_LAUNCHES)


class Conv3x3(torch.autograd.Function):
    """The eager route of ``conv3x3``: the wrappers, called directly."""

    @staticmethod
    def forward(ctx, x, w):
        # The wrappers take contiguous tensors; a net may hand over a strided
        # view (a no-op copy otherwise).
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        return conv3x3_fwd(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        dx = conv3x3_fwd(g, w, True) if ctx.needs_input_grad[0] else None
        dw = None
        if ctx.needs_input_grad[1]:  # in w's dtype; bf16 x, fp32 w: rounded to bf16, in fp32
            mixed = x.dtype == _BF16 and w.dtype == _FP32
            dw = conv3x3_dw(x, g, round_bf16=mixed) if mixed else conv3x3_dw(x, g).to(w.dtype)
        return dx, dw


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


def traced(x: torch.Tensor) -> bool:
    """Is ``x`` a tracer's tensor (``torch.export``'s fake tensors, or
    ``torch.compile``'s), not one of an eager run?"""
    return type(x) is not torch.Tensor or torch.compiler.is_compiling()


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable 3x3 SAME conv (stride 1, NCHW, OIHW) through K2: the
    custom op when traced, else ``Conv3x3`` (or, with no gradient to
    record, the forward wrapper itself).  bf16 ``x`` takes fp32 ``w`` only
    eagerly (the custom op takes one dtype)."""
    if traced(x):
        return conv3x3_op(x, w, False)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return Conv3x3.apply(x, w)
    return conv3x3_fwd(x.contiguous(), w.contiguous())
