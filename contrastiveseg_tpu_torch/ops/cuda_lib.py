"""Build, load and launch the port's hand-written CUDA kernels.

Each source under ``csrc/`` is one shared library with a plain C interface:
``nvcc`` compiles it for ``sm_90a`` into ``build/kernels/`` (gitignored),
named by the hash of the source and the shared headers (``csrc/*.cuh``) so
that an edit rebuilds, at first use and never at import; ``ctypes`` loads
it.  Every entry point launches on the stream it is given, does not
synchronise, and returns ``cudaGetLastError()`` (0 on success); ``launch``
raises on anything else.  ``build_all`` starts one ``nvcc`` per source at
once and waits for all of them.

The checks and pointer helpers here are shared by the wrappers of
``ops/contrast_cuda.py`` (K1), ``ops/conv_cuda.py`` (K2) and
``ops/block_cuda.py`` (K3).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): cannot build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


class CudaLibrary:
    """One ``csrc/<source>`` library: its entry points' ctypes signatures
    (``{name: argtypes}``, each returning an int error code), an optional
    init entry point run once per device, its error-string function, and
    the ``-D`` macros it is built with (none for the port's kernels; a
    diagnostic variant of a source sets its switch here)."""

    def __init__(self, source: str, signatures: dict[str, list],
                 error_string: str, init: str | None = None,
                 defines: tuple[str, ...] = ()):
        self.source = CSRC / source
        self.signatures = signatures
        self.error_string = error_string
        self.init = init
        self.defines = tuple(defines)
        self._lib: ctypes.CDLL | None = None
        self._ready: set[int] = set()
        self._fns: dict[tuple[str, int], object] = {}

    def library_path(self) -> Path:
        """Named by the hash of the source, the headers of ``csrc/`` and the
        macros, so that an edit to any of them rebuilds."""
        key = b"".join(p.read_bytes() for p in [self.source, *sorted(CSRC.glob("*.cuh"))])
        key += "".join(f" -D{d}" for d in self.defines).encode()
        digest = hashlib.sha256(key).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.source.stem}_{digest}.so"

    def ptxas_report(self) -> str:
        """What ``-Xptxas -v`` printed (registers, shared memory, spills)."""
        return self.library_path().with_suffix(".ptxas.txt").read_text()

    def _start(self, force: bool):
        out = self.library_path()
        if out.exists() and not force:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in self.defines),
                                 "-o", str(tmp), str(self.source)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        return proc, tmp, out, time.perf_counter()

    def _finish(self, started) -> tuple[Path, float]:
        if started is None:
            return self.library_path(), 0.0
        proc, tmp, out, t0 = started
        _, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building {self.source}:\n{err}")
        out.with_suffix(".ptxas.txt").write_text(err)
        os.replace(tmp, out)
        return out, seconds

    def build(self, force: bool = False) -> tuple[Path, float]:
        """Compile if not built yet (always, with ``force``).  Returns (library
        path, seconds spent compiling; 0.0 if it was already built)."""
        return self._finish(self._start(force))

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = I
            if self.init:
                getattr(lib, self.init).argtypes = []
                getattr(lib, self.init).restype = I
            getattr(lib, self.error_string).argtypes = [I]
            getattr(lib, self.error_string).restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def _raise(self, what: str, err: int) -> None:
        msg = getattr(self.lib(), self.error_string)(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")

    def ready(self, index: int) -> ctypes.CDLL:
        """The library, with its init run on CUDA device ``index`` (once)."""
        lib = self.lib()
        if self.init and index not in self._ready:
            with torch.cuda.device(index):
                err = getattr(lib, self.init)()
            if err != 0:
                self._raise(f"{self.init} failed on cuda:{index}", err)
        self._ready.add(index)
        return lib

    def launch(self, fn_name: str, device: torch.device, *args) -> None:
        """Call entry point ``fn_name`` (pointers and the stream as ints or
        ``c_void_p``) once the library is ready on ``device``; raise on a
        non-zero return."""
        fn = self._fns.get((fn_name, device.index))
        if fn is None:
            fn = self._fns[fn_name, device.index] = getattr(self.ready(device.index), fn_name)
        err = fn(*args)
        if err != 0:
            self._raise(f"{fn_name} failed to launch", err)


def build_all(libraries, force: bool = False) -> list[tuple[Path, float]]:
    """Build every library, one ``nvcc`` each, all started together."""
    started = [lib._start(force) for lib in libraries]
    return [lib._finish(s) for lib, s in zip(libraries, started)]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check(name: str, x: torch.Tensor, dtype, shape: tuple,
          device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous tensor of this dtype (or one of
    these dtypes), shape and device."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    dtypes = dtype if isinstance(dtype, tuple) else (dtype,)
    if x.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_cuda(name: str, x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, got {x.device}")
    return x.device


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the int its handle is."""
    return _raw_stream(device.index)


def _public_raw_stream(index: int) -> int:
    return torch.cuda.current_stream(index).cuda_stream


# PyTorch's own accessor of the stream handle (what its Triton launchers
# call): no Stream object a call.  The public API where it is missing.
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or _public_raw_stream


def ptrs(*xs: torch.Tensor) -> list[ctypes.c_void_p]:
    return [ctypes.c_void_p(x.data_ptr()) for x in xs]
