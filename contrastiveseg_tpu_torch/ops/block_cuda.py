"""K3 on the card: the fused inference BasicBlock as hand-written CUDA.

Replaces the Pallas kernel ``_fused_block_kernel`` of
``contrastiveseg_tpu/ops/block_pallas.py`` (:51); the kernel and its design
notes are in ``csrc/fused_block.cu``, built by ``ops/cuda_lib.py``.

``fused_basic_block_eval(x, w1, s1, b1, w2, s2, b2)``:
  * takes the plain version, ``ops/block.reference_block_eval``, for CPU
    tensors, and only for those;
  * for CUDA tensors folds s1 and s2 into the weights (the kernel rounds
    them to x's dtype, as the JAX wrapper does: bf16 as it packs them,
    round to nearest even like ``Tensor.to``), checks device, dtype (fp32
    or bf16 x; fp32 weights, scales and biases), shape (C <= 64) and
    contiguity, launches on the current stream and raises if
    ``cudaGetLastError()`` is not 0;
  * counts its launches in ``fused_basic_block_eval.launches``.
"""

from __future__ import annotations

import torch

from contrastiveseg_tpu_torch.ops import cuda_lib
from contrastiveseg_tpu_torch.ops.block import fold_weights, reference_block_eval
from contrastiveseg_tpu_torch.ops.cuda_lib import I, P, check, ptrs, stream

LIBRARY = cuda_lib.CudaLibrary(
    "fused_block.cu",
    {"fused_block": [P] * 6 + [I, I, I, I, I, P]},
    error_string="fused_block_error_string", init="fused_block_init")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_C = 64  # csrc MAX_C


def fused_basic_block_eval(x, w1, s1, b1, w2, s2, b2) -> torch.Tensor:
    """relu(conv2(relu(conv1(x)·s1+b1))·s2+b2 + x) of NCHW ``x`` in one
    kernel; OIHW ``w1``, ``w2`` ``[C, C, 3, 3]``; ``s*``, ``b*`` ``[C]``."""
    if x.device.type == "cpu":
        return reference_block_eval(x, w1, s1, b1, w2, s2, b2)
    dev = cuda_lib.require_cuda("K3", x)
    if x.dim() != 4:
        raise ValueError(f"K3 takes NCHW input, got shape {tuple(x.shape)}")
    B, C, H, W = x.shape
    if C > _MAX_C:
        raise ValueError(f"K3 supports C <= {_MAX_C}, got {C}")
    check("x", x, tuple(_DTYPES), (B, C, H, W), dev)
    for name, v in (("w1", w1), ("w2", w2)):
        check(name, v, torch.float32, (C, C, 3, 3), dev)
    for name, v in (("s1", s1), ("b1", b1), ("s2", s2), ("b2", b2)):
        check(name, v, torch.float32, (C,), dev)
    w1f = fold_weights(w1, s1, torch.float32)
    w2f = fold_weights(w2, s2, torch.float32)
    y = torch.empty_like(x)
    LIBRARY.launch("fused_block", dev, *ptrs(x, w1f, w2f, b1, b2, y), B, C, H, W,
                   _DTYPES[x.dtype], stream(dev))
    fused_basic_block_eval.launches += 1
    return y


fused_basic_block_eval.launches = 0

# (wrapper, plain version, TPU kernel it replaces).
KERNELS = {
    "fused_block": (fused_basic_block_eval, reference_block_eval,
                    "contrastiveseg_tpu/ops/block_pallas.py:51"),
}


def reset_launch_counts() -> None:
    fused_basic_block_eval.launches = 0


def launch_counts() -> dict[str, int]:
    return {"fused_block": fused_basic_block_eval.launches}
