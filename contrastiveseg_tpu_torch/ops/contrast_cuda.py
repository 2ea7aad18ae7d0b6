"""K1 on the card: the anchor x memory-bank InfoNCE as hand-written CUDA.

Replaces the Pallas kernels of ``contrastiveseg_tpu/ops/contrast_pallas.py``
(``_pass1_kernel`` :50, ``_pass2_kernel`` :75, ``_bwd_kernel`` :98); the
kernels and their design notes are in ``csrc/contrast_infonce.cu``.  All
three run 3xTF32 tensor-core products over anchor chunks of at most 64
columns, with one split rule (``chunk_splits``).

Build: ``ops/cuda_lib.py`` (nvcc for ``sm_90a`` at first use into
``build/kernels/``, ctypes); ``infonce_init`` runs once per device.

Each wrapper (``infonce_pass1``, ``infonce_pass2``, ``infonce_bwd``):
  * takes the plain version in ``ops/contrast_stream.py`` for CPU tensors,
    and only for those;
  * for CUDA tensors checks device, dtype, shape and contiguity, allocates
    outputs and split partials with ``torch.empty``, launches on the current
    stream and raises if ``cudaGetLastError()`` is not 0;
  * counts its launches in ``<wrapper>.launches``.

``cuda_contrastive_loss`` is the differentiable loss over the three.
"""

from __future__ import annotations

import torch

from contrastiveseg_tpu_torch.ops import cuda_lib
from contrastiveseg_tpu_torch.ops.contrast_stream import (
    InfoNCE,
    Passes,
    stream_bwd,
    stream_pass1,
    stream_pass2,
)
from contrastiveseg_tpu_torch.ops.cuda_lib import P, I, F, check, ptrs, stream

LIBRARY = cuda_lib.CudaLibrary(
    "contrast_infonce.cu",
    {"infonce_pass1": [P] * 11 + [I, I, I, I, F, P],
     "infonce_pass2": [P] * 9 + [I, I, I, I, F, P],
     "infonce_bwd": [P] * 11 + [I, I, I, I, F, P]},
    error_string="infonce_error_string", init="infonce_init")
_ROWS = 64  # bank rows per tile (csrc ROWS)
_MAX_MC = 64  # anchors per chunk (csrc MAX_MC)
_MAX_D = 256  # largest feature width (csrc MAX_D)


def _check_inputs(a_f, a_l, c_f, c_l, c_v, **rows):
    dev = cuda_lib.require_cuda("K1", a_f)
    M, D = a_f.shape
    K = c_f.shape[0]
    if D > _MAX_D:
        raise ValueError(f"K1 supports D <= {_MAX_D}, got {D}")
    if M == 0 or K == 0:
        raise ValueError(f"K1 needs non-empty inputs, got M={M} K={K}")
    check("a_f", a_f, torch.float32, (M, D), dev)
    check("a_l", a_l, torch.int32, (M,), dev)
    check("c_f", c_f, torch.float32, (K, D), dev)
    check("c_l", c_l, torch.int32, (K,), dev)
    check("c_v", c_v, torch.bool, (K,), dev)
    for name, x in rows.items():
        check(name, x, torch.float32, (M,), dev)
    return M, K, D


def chunk_splits(M: int, K: int, device: torch.device) -> int:
    """K1's K splits: (anchor chunks x splits) is one wave of one block per
    SM (each block takes ~200 KB of shared memory at D=256)."""
    sms = cuda_lib.sm_count(device.index)
    chunks = -(-M // _MAX_MC)
    n_tiles = -(-K // _ROWS)
    return max(1, min(n_tiles, sms // chunks))


def infonce_pass1(a_f, a_l, c_f, c_l, c_v, temperature):
    """K1a: -> (m, ns, p), each [M] fp32."""
    if a_f.device.type == "cpu":
        return stream_pass1(a_f, a_l, c_f, c_l, c_v, temperature)
    M, K, D = _check_inputs(a_f, a_l, c_f, c_l, c_v)
    S = chunk_splits(M, K, a_f.device)
    part = torch.empty((3, S, M), dtype=torch.float32, device=a_f.device)
    out = torch.empty((3, M), dtype=torch.float32, device=a_f.device)
    LIBRARY.launch("infonce_pass1", a_f.device,
                   *ptrs(a_f, a_l, c_f, c_l, c_v, part[0], part[1], part[2],
                         out[0], out[1], out[2]),
                   M, K, D, S, 1.0 / temperature, stream(a_f.device))
    infonce_pass1.launches += 1
    return out[0], out[1], out[2]


def infonce_pass2(a_f, a_l, c_f, c_l, c_v, m, ns, temperature):
    """K1b: -> (s1, t), each [M] fp32."""
    if a_f.device.type == "cpu":
        return stream_pass2(a_f, a_l, c_f, c_l, c_v, m, ns, temperature)
    M, K, D = _check_inputs(a_f, a_l, c_f, c_l, c_v, m=m, ns=ns)
    S = chunk_splits(M, K, a_f.device)
    part = torch.empty((S, 2, M), dtype=torch.float32, device=a_f.device)
    out = torch.empty((2, M), dtype=torch.float32, device=a_f.device)
    LIBRARY.launch("infonce_pass2", a_f.device,
                   *ptrs(a_f, a_l, c_f, c_l, c_v, m, ns, part, out),
                   M, K, D, S, 1.0 / temperature, stream(a_f.device))
    infonce_pass2.launches += 1
    return out[0], out[1]


def infonce_bwd(a_f, a_l, c_f, c_l, c_v, m, ns, t, w, temperature):
    """K1c: -> dA [M, D] fp32 for per-row loss weights ``w``."""
    if a_f.device.type == "cpu":
        return stream_bwd(a_f, a_l, c_f, c_l, c_v, m, ns, t, w, temperature)
    M, K, D = _check_inputs(a_f, a_l, c_f, c_l, c_v, m=m, ns=ns, t=t, w=w)
    S = chunk_splits(M, K, a_f.device)
    part = torch.empty((S, M, D), dtype=torch.float32, device=a_f.device)
    da = torch.empty((M, D), dtype=torch.float32, device=a_f.device)
    LIBRARY.launch("infonce_bwd", a_f.device,
                   *ptrs(a_f, a_l, c_f, c_l, c_v, m, ns, t, w, part, da),
                   M, K, D, S, 1.0 / temperature, stream(a_f.device))
    infonce_bwd.launches += 1
    return da


infonce_pass1.launches = 0
infonce_pass2.launches = 0
infonce_bwd.launches = 0

CUDA_PASSES = Passes(infonce_pass1, infonce_pass2, infonce_bwd)

# (wrapper, plain version, TPU kernel it replaces) for each kernel of K1.
KERNELS = {
    "infonce_pass1": (infonce_pass1, stream_pass1,
                      "contrastiveseg_tpu/ops/contrast_pallas.py:50"),
    "infonce_pass2": (infonce_pass2, stream_pass2,
                      "contrastiveseg_tpu/ops/contrast_pallas.py:75"),
    "infonce_bwd": (infonce_bwd, stream_bwd,
                    "contrastiveseg_tpu/ops/contrast_pallas.py:98"),
}


def reset_launch_counts() -> None:
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: w.launches for name, (w, _, _) in KERNELS.items()}


def cuda_contrastive_loss(a_f, a_l, a_v, c_f, c_l, c_v, temperature: float,
                          base_temperature: float) -> torch.Tensor:
    """``pallas_contrastive_loss`` on K1: value through K1a+K1b, gradient
    w.r.t. the anchors through K1c; the contrast set gets no gradient."""
    return InfoNCE.apply(a_f, a_l, a_v, c_f.detach(), c_l, c_v, temperature,
                         base_temperature, CUDA_PASSES)
