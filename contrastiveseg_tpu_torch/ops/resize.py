"""Image resizes with exact PyTorch interpolation semantics.

Counterpart of ``contrastiveseg_tpu/ops/resize.py``.  Bilinear
``align_corners=True`` resize is separable, so both packages build the same
numpy ``[out, in]`` interpolation matrices and contract them with the input
(``torch.einsum`` here), which keeps the two within fp32 rounding of each
other and of ``F.interpolate(..., align_corners=True)``.

The model resizes NCHW (``resize_bilinear_align_corners_nchw``);
``resize_bilinear_align_corners`` takes NHWC (or NHW) like the JAX package
and permutes around it.

The half-pixel bilinear resize (torch ``align_corners=False``, :156-193) is
built the same way from ``_half_pixel_matrix``.  The nearest resize
(:53-64, :113-126) picks ``floor(dst * in / out)`` computed in float64, as
the JAX package's ``_nearest_matrix`` does, and gathers those rows and
columns: ``F.interpolate(mode="nearest")`` computes its scale in float32
and can pick another row at a non-integer ratio (32 -> 65, say).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=128)
def _align_corners_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Row-stochastic [out, in] matrix for align_corners=True linear interp."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    if out_size == 1 or in_size == 1:
        A[:, 0] = 1.0
        return A
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    A[np.arange(out_size), lo] += 1.0 - frac
    A[np.arange(out_size), hi] += frac
    return A


def align_corners_matrix(out_size: int, in_size: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """``_align_corners_matrix`` as an fp32 tensor on ``device``."""
    return torch.from_numpy(_align_corners_matrix(out_size, in_size)).to(device)


def resize_bilinear_align_corners_nchw(
    x: torch.Tensor, size: tuple[int, int]
) -> torch.Tensor:
    """Bilinear align_corners=True resize of an NCHW tensor."""
    h_out, w_out = size
    h_in, w_in = x.shape[2], x.shape[3]
    if (h_in, w_in) == (h_out, w_out):
        return x
    a_h = align_corners_matrix(h_out, h_in, x.device).to(x.dtype)
    a_w = align_corners_matrix(w_out, w_in, x.device).to(x.dtype)
    out = torch.einsum("op,bcpq->bcoq", a_h, x)
    return torch.einsum("oq,bciq->bcio", a_w, out)


def resize_bilinear_align_corners(
    x: torch.Tensor, size: tuple[int, int]
) -> torch.Tensor:
    """Bilinear align_corners=True resize of an NHWC (or NHW) tensor."""
    return _nhwc(resize_bilinear_align_corners_nchw, x, size)


def _nhwc(resize_nchw, x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``resize_nchw`` of an NHWC (or NHW) tensor, permuted around it."""
    squeeze = x.ndim == 3
    if squeeze:
        x = x[..., None]
    x = resize_nchw(x.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1)
    return x[..., 0] if squeeze else x


@functools.lru_cache(maxsize=128)
def _half_pixel_matrix(out_size: int, in_size: int) -> np.ndarray:
    """Row-stochastic [out, in] matrix for torch ``align_corners=False``
    linear interp: ``src = max(0, (dst + 0.5) * in/out - 0.5)`` with the
    high tap clamped to the last pixel."""
    A = np.zeros((out_size, in_size), dtype=np.float32)
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.maximum(src, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), in_size - 1)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo).astype(np.float32)
    A[np.arange(out_size), lo] += 1.0 - frac
    A[np.arange(out_size), hi] += frac
    return A


def resize_bilinear_half_pixel_nchw(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Bilinear ``align_corners=False`` resize of an NCHW tensor (no
    antialiasing when it shrinks, as torch's)."""
    h_out, w_out = size
    h_in, w_in = x.shape[2], x.shape[3]
    if (h_in, w_in) == (h_out, w_out):
        return x
    a_h = torch.from_numpy(_half_pixel_matrix(h_out, h_in)).to(x.device, x.dtype)
    a_w = torch.from_numpy(_half_pixel_matrix(w_out, w_in)).to(x.device, x.dtype)
    out = torch.einsum("op,bcpq->bcoq", a_h, x)
    return torch.einsum("oq,bciq->bcio", a_w, out)


def resize_bilinear_half_pixel(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``resize_bilinear_half_pixel_nchw`` of an NHWC (or NHW) tensor."""
    return _nhwc(resize_bilinear_half_pixel_nchw, x, size)


def _nearest_index(out_size: int, in_size: int) -> np.ndarray:
    src = np.floor(np.arange(out_size, dtype=np.float64) * in_size / out_size)
    return np.clip(src.astype(np.int64), 0, in_size - 1)


def resize_nearest_nchw(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """Nearest resize of an NCHW tensor, torch's ``src = floor(dst * in /
    out)`` in float64 (the JAX package's ``_nearest_matrix``)."""
    h_out, w_out = size
    h_in, w_in = x.shape[2], x.shape[3]
    if (h_in, w_in) == (h_out, w_out):
        return x
    rows = torch.from_numpy(_nearest_index(h_out, h_in)).to(x.device)
    cols = torch.from_numpy(_nearest_index(w_out, w_in)).to(x.device)
    return x.index_select(2, rows).index_select(3, cols)


def resize_nearest(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """``resize_nearest_nchw`` of an NHWC (or NHW) tensor."""
    return _nhwc(resize_nearest_nchw, x, size)


def scale_target_nearest(labels: torch.Tensor,
                         size: tuple[int, int]) -> torch.Tensor:
    """Downscale integer label maps [B, H, W] with torch 'nearest' semantics
    (``src = floor(dst * in / out)``), by index gather."""
    return resize_nearest(labels, size)


def subsample_stride(labels: torch.Tensor, stride: int) -> torch.Tensor:
    """``labels[:, ::stride, ::stride]`` (reference trainer_contrastive.py:108)."""
    return labels[:, ::stride, ::stride]
