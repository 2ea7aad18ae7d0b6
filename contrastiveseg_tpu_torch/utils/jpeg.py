"""JPEG frames without PIL: ``read_jpeg`` through the native decoder
``csrc/jpeg_decode.cpp`` (built by ``data/native.JPEG_LIBRARY`` at first
use).

The JAX package reads a frame as ``np.asarray(Image.open(p))``, or with
``convert("RGB")`` (``contrastiveseg_tpu/data/datasets.py``); ``read_jpeg``
gives the same array, value, dtype and shape, bit for bit, of what PIL 12.1
with libjpeg-turbo 3.1 decodes: uint8 [H, W] for a grey frame, [H, W, 3]
for YCbCr or RGB, [H, W, 4] for CMYK and YCCK (Pillow's inverted Adobe
reading), and with ``rgb`` the [H, W, 3] of Pillow's ``convert("RGB")``.
The whole decode is one call into the library, which releases the GIL.

There is no fallback: if the library cannot be built or loaded, or the file
is one it refuses (arithmetic coding, 12-bit, lossless or hierarchical
frames, an unusual sampling or component count: ``UnsupportedJPEG``), or
truncated or corrupt, ``read_jpeg`` raises a RuntimeError that names the
file.  EXIF orientation
is not applied, as PIL does not apply it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from contrastiveseg_tpu_torch.data import native

SIDECAR_TOOL = "tools/cache_dataset_torch.py"
# The decoder's error codes (``Err`` in csrc/jpeg_decode.cpp).
_CORRUPT = {1: "is not a JPEG file", 2: "is truncated", 3: "is corrupt"}
_UNSUPPORTED = {
    10: "uses arithmetic coding (SOF9-11)",
    11: "has a sample precision other than 8 bits",
    12: "is a lossless JPEG (SOF3)",
    13: "is a hierarchical JPEG (SOF5-7)",
    14: "has sampling factors libjpeg cannot upsample",
    15: "has a component count other than 1, 3 or 4",
    16: "is a progressive JPEG with incomplete scans, which libjpeg smooths",
}


class UnsupportedJPEG(RuntimeError):
    """A JPEG of a format the decoder refuses (``_UNSUPPORTED``), which PIL
    may read: ``tools/cache_dataset_torch.py`` writes its sidecar through
    PIL."""


def _error(code: int, name: str) -> RuntimeError:
    if code in _UNSUPPORTED:
        return UnsupportedJPEG(
            f"{name} {_UNSUPPORTED[code]}: the port's JPEG decoder does not read it; write its "
            f"sidecar on a machine with PIL with `python {SIDECAR_TOOL} --root <data_dir>`")
    return RuntimeError(f"{name} {_CORRUPT.get(code, f'fails to decode (code {code})')}")


def decode_jpeg(data: bytes, rgb: bool = False, name: str = "<JPEG bytes>") -> np.ndarray:
    """The array PIL gives for the JPEG ``data`` (see the module)."""
    lib = native.JPEG_LIBRARY.get()
    if lib is None:
        raise RuntimeError(f"cannot decode {name}: the JPEG library did not build or load "
                           f"({native.JPEG_LIBRARY.error})")
    src = np.frombuffer(data, np.uint8)
    ptr = src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    info = np.zeros(3, np.int32)
    code = lib.jpeg_info(ptr, src.size, info.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if code:
        raise _error(code, name)
    h, w, channels = (int(v) for v in info)
    channels = 3 if rgb else channels
    out = np.empty((h, w, channels) if channels > 1 else (h, w), np.uint8)
    code = lib.jpeg_decode(ptr, src.size, int(rgb),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.size)
    if code:
        raise _error(code, name)
    return out


def read_jpeg(path, rgb: bool = False) -> np.ndarray:
    """``np.asarray(Image.open(path))``, or with ``rgb``
    ``np.asarray(Image.open(path).convert("RGB"))``, without PIL."""
    return decode_jpeg(Path(path).read_bytes(), rgb, str(path))
