"""Build and load the port's hand-written CUDA kernels.

Each kernel is one ``.cu`` file under ``surfelmapping_tpu_torch/csrc/`` with
a plain C interface.  ``nvcc`` compiles it for Hopper (``sm_90a``) into a
shared library under ``build/surfelmapping_tpu_torch/`` at first use, and
``ctypes`` loads it: no PyTorch headers, so a build takes seconds.  The
library's file name carries a digest of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.

A wrapper hands the kernel raw device pointers and PyTorch's current stream;
the C entry point launches on that stream, does not synchronise, and
returns ``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "surfelmapping_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise FileNotFoundError("nvcc not found: the CUDA kernels build on a "
                                "machine with the CUDA toolkit")
    return path


class CudaKernel:
    """One kernel source: its build, its loaded library, its launch count.

    ``functions`` maps each exported C function to (restype, argtypes).
    ``launches`` is incremented by the wrapper once per kernel launch."""

    def __init__(self, name: str, source: str, functions: dict,
                 extra_flags: tuple[str, ...] = ()):
        self.name = name
        self.source = CSRC_DIR / source
        self.functions = functions
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.launches = 0
        self.build_log = ""
        self._lib = None

    @property
    def repo_source(self) -> str:
        return str(self.source.relative_to(PKG_DIR.parent))

    def library_path(self) -> Path:
        digest = hashlib.sha256(
            self.source.read_bytes() + " ".join(self.flags).encode()
        ).hexdigest()[:12]
        return BUILD_DIR / f"lib{self.name}-{digest}.so"

    def _start_build(self) -> subprocess.Popen | None:
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *self.flags, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc: subprocess.Popen | None) -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source}:\n{log}")
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        os.replace(tmp, self.library_path())

    def lib(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        if self._lib is None:
            build_all([self])
            lib = ctypes.CDLL(str(self.library_path()))
            for fname, (restype, argtypes) in self.functions.items():
                fn = getattr(lib, fname)
                fn.restype = restype
                fn.argtypes = argtypes
            lib.kernel_error_string.restype = ctypes.c_char_p
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            self._lib = lib
        return self._lib

    def check(self, rc: int) -> None:
        if rc != 0:
            msg = self.lib().kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.name}: CUDA error {rc} ({msg})")


class LaunchCount:
    """The launch count of one entry point, where one kernel source serves
    several; the wrapper increments ``launches`` beside the kernel's own."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def build_all(kernels: list[CudaKernel]) -> None:
    """Build every kernel that is not built yet: one ``nvcc`` per source,
    all started together, then waited for."""
    procs = [(k, k._start_build()) for k in kernels]
    for k, proc in procs:
        k._finish_build(proc)


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, for a C launch."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """The checks a wrapper makes before it hands a pointer to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
