"""ctypes bindings for the native data-path kernels: ``native/segdata.cpp``,
the port's PNG unfilter, ``csrc/png_unfilter.cpp``, and its JPEG decoder,
``csrc/jpeg_decode.cpp``.

Counterpart of ``contrastiveseg_tpu/data/native.py``, with its own build:
at first use, never at import, ``g++`` compiles each source with the flags
of ``native/Makefile`` into its own directory of ``build/`` (gitignored),
named by the hash of the source and the flags, as ``ops/cuda_lib.py`` names
the CUDA libraries.  The library committed as ``native/libsegdata.so`` is
never loaded: it was built with ``-march=native`` on another host.

Bound from segdata: the bicubic resize (whole and windowed), the nearest
label resize and the two normalizes.  The port's confusion matrix runs on
the device (``ops/confusion.py``), so ``confusion_matrix_i64`` is not bound.
Bound from the PNG library: ``png_unfilter``, the five PNG row filters
undone for ``utils/png.py``.  Every wrapper returns None when its library
could not be built or loaded; its caller then takes the numpy or Python
fallback, and the library's ``fallbacks`` counts those calls.  The JPEG
library (``jpeg_info``, ``jpeg_decode``) has no fallback: ``utils/jpeg.py``
raises where it cannot be loaded.  ``route()`` says which route the process
took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "segdata.cpp"
BUILD_DIR = ROOT / "build" / "segdata"
PNG_SOURCE = ROOT / "contrastiveseg_tpu_torch" / "csrc" / "png_unfilter.cpp"
PNG_BUILD_DIR = ROOT / "build" / "pngunfilter"
JPEG_SOURCE = ROOT / "contrastiveseg_tpu_torch" / "csrc" / "jpeg_decode.cpp"
JPEG_BUILD_DIR = ROOT / "build" / "jpegdecode"
CXX_FLAGS = ["-O3", "-march=native", "-ffast-math", "-fPIC", "-shared", "-std=c++17"]

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_I, _F = ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "resize_bicubic_u8": [_u8p, _I, _I, _I, _u8p, _I, _I],
    "resize_bicubic_window_u8": [_u8p, _I, _I, _I, _u8p, _I, _I, _I, _I, _I, _I],
    "resize_nearest_i32": [_i32p, _I, _I, _i32p, _I, _I],
    "normalize_pad_f32": [_u8p, _I, _I, _I, _f32p, _I, _I, _I, _I, _F, _f32p, _f32p],
    "normalize_f32": [_u8p, ctypes.c_int64, _I, _f32p, _F, _f32p, _f32p],
}
PNG_SIGNATURES = {"png_unfilter": ([_u8p, ctypes.c_int64, ctypes.c_int64, _I, _u8p],
                                   ctypes.c_int64)}
JPEG_SIGNATURES = {"jpeg_info": ([_u8p, ctypes.c_int64, _i32p], _I),
                   "jpeg_decode": ([_u8p, ctypes.c_int64, _I, _u8p, ctypes.c_int64], _I)}


class SegdataLibrary:
    """One native library of one build directory, built and loaded once:
    by default segdata.  ``signatures`` maps each entry point to its
    argument types, or to (argument types, return type); ``stem`` names the
    built file, and ``fallback`` is what ``route()`` says when the callers
    take their fallback."""

    def __init__(self, build_dir: Path = BUILD_DIR, source: Path = SOURCE,
                 signatures: Optional[dict] = None, stem: str = "libsegdata",
                 fallback: str = "numpy"):
        self.build_dir = Path(build_dir)
        self.source = Path(source)
        self.signatures = SIGNATURES if signatures is None else signatures
        self.stem = stem
        self.fallback = fallback
        self.fallbacks = 0
        self.error: Optional[str] = None
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._tried = False

    def library_path(self) -> Path:
        key = self.source.read_bytes() + " ".join(CXX_FLAGS).encode()
        digest = hashlib.sha256(key).hexdigest()[:12]
        return self.build_dir / f"{self.stem}_{digest}.so"

    def build(self) -> Path:
        """Compile unless built; raises RuntimeError if ``g++`` fails."""
        out = self.library_path()
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        try:
            proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(self.source)],
                                  capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"g++ could not build {self.source}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}) building "
                               f"{self.source}:\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def lib(self) -> Optional[ctypes.CDLL]:
        """The loaded library, or None (and ``error`` says why) if it could
        not be built or loaded; tried once per object."""
        with self._lock:
            if self._tried:
                return self._lib
            self._tried = True
            try:
                lib = ctypes.CDLL(str(self.build()))
            except (RuntimeError, OSError) as e:
                self.error = str(e)
                return None
            for name, sig in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = sig if isinstance(sig, tuple) else (sig, None)
            self._lib = lib
            return lib

    def route(self) -> str:
        """The loaded library's path, or ``fallback`` when the fallbacks run."""
        lib = self.lib()
        return lib._name if lib is not None else self.fallback

    def get(self) -> Optional[ctypes.CDLL]:
        """``lib()`` for a wrapper: counts a fallback when there is none."""
        lib = self.lib()
        if lib is None:
            with self._lock:
                self.fallbacks += 1
        return lib


LIBRARY = SegdataLibrary()
PNG_LIBRARY = SegdataLibrary(PNG_BUILD_DIR, PNG_SOURCE, PNG_SIGNATURES, stem="libpngunfilter",
                             fallback="python")
JPEG_LIBRARY = SegdataLibrary(JPEG_BUILD_DIR, JPEG_SOURCE, JPEG_SIGNATURES,
                              stem="libjpegdecode", fallback="none")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resize_bicubic_u8(img: np.ndarray, size_wh: tuple[int, int]) -> Optional[np.ndarray]:
    """cv2.INTER_CUBIC-equivalent uint8 resize; None if native unavailable."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    ch = img.shape[2] if img.ndim == 3 else 1
    dw, dh = size_wh
    out = np.empty((dh, dw, ch) if img.ndim == 3 else (dh, dw), np.uint8)
    lib.resize_bicubic_u8(_ptr(img, ctypes.c_uint8), h, w, ch,
                          _ptr(out, ctypes.c_uint8), dh, dw)
    return out


def resize_bicubic_window_u8(
    img: np.ndarray, virtual_wh: tuple[int, int],
    window_xywh: tuple[int, int, int, int],
) -> Optional[np.ndarray]:
    """The ``window_xywh`` = (x0, y0, w, h) crop of the virtual
    ``virtual_wh`` bicubic resize of ``img``, without materializing the
    rest: bit-identical to ``resize_bicubic_u8(img, virtual_wh)[y0:y0+h,
    x0:x0+w]``.  None if native unavailable."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w = img.shape[:2]
    ch = img.shape[2] if img.ndim == 3 else 1
    vdw, vdh = virtual_wh
    x0, y0, ow, oh = window_xywh
    out = np.empty((oh, ow, ch) if img.ndim == 3 else (oh, ow), np.uint8)
    lib.resize_bicubic_window_u8(_ptr(img, ctypes.c_uint8), h, w, ch,
                                 _ptr(out, ctypes.c_uint8), vdh, vdw, y0, x0, oh, ow)
    return out


def resize_nearest_i32(x: np.ndarray, size_wh: tuple[int, int]) -> Optional[np.ndarray]:
    lib = LIBRARY.get()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.int32)
    h, w = x.shape
    dw, dh = size_wh
    out = np.empty((dh, dw), np.int32)
    lib.resize_nearest_i32(_ptr(x, ctypes.c_int32), h, w, _ptr(out, ctypes.c_int32), dh, dw)
    return out


def normalize_pad_f32(
    img: np.ndarray, canvas_hw: tuple[int, int], offset_yx: tuple[int, int],
    div_value: float, mean: np.ndarray, std: np.ndarray,
    out: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """uint8 HWC -> ((img / div) - mean) / std at ``offset_yx`` of a zero
    float32 canvas (``out`` if given); None if native unavailable."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    h, w, ch = img.shape
    dh, dw = canvas_hw
    if out is None:
        out = np.empty((dh, dw, ch), np.float32)
    elif out.shape != (dh, dw, ch) or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a contiguous float32 {(dh, dw, ch)} array")
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.normalize_pad_f32(_ptr(img, ctypes.c_uint8), h, w, ch,
                          _ptr(out, ctypes.c_float), dh, dw, offset_yx[0], offset_yx[1],
                          ctypes.c_float(div_value), _ptr(mean, ctypes.c_float),
                          _ptr(std, ctypes.c_float))
    return out


def normalize_f32(img: np.ndarray, div_value: float, mean: np.ndarray,
                  std: np.ndarray) -> Optional[np.ndarray]:
    """Bit-identical native ((img / div) - mean) / std for uint8 HWC input;
    None if native unavailable."""
    lib = LIBRARY.get()
    if lib is None:
        return None
    img = np.ascontiguousarray(img, dtype=np.uint8)
    ch = img.shape[-1] if img.ndim == 3 else 1
    out = np.empty(img.shape, np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    lib.normalize_f32(_ptr(img, ctypes.c_uint8), ctypes.c_int64(img.size // ch), ch,
                      _ptr(out, ctypes.c_float), ctypes.c_float(div_value),
                      _ptr(mean, ctypes.c_float), _ptr(std, ctypes.c_float))
    return out


def png_unfilter(data: bytes, h: int, stride: int, bpp: int) -> Optional[np.ndarray]:
    """[h, stride] uint8 scanlines of the decompressed PNG stream ``data``
    (h rows of a filter-type byte and ``stride`` bytes); None if native
    unavailable.  Raises ValueError on a truncated stream or an unknown
    filter type, as ``utils/png._unfilter`` does."""
    lib = PNG_LIBRARY.get()
    if lib is None:
        return None
    if len(data) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    src = np.frombuffer(data, np.uint8, h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    bad = lib.png_unfilter(_ptr(src, ctypes.c_uint8), h, stride, bpp,
                           _ptr(out, ctypes.c_uint8))
    if bad >= 0:
        raise ValueError(f"PNG row {bad} has an unknown filter type {src[bad * (stride + 1)]}")
    return out
