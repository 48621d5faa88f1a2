"""ctypes bindings of the port's native IO library (counterpart of
surfelmapping_tpu/io/native.py): a multithreaded libpng frame prefetcher,
a PNG decoder and the reference-format map file IO.

The library is the port's own copy of the C++ source,
``surfelmapping_tpu_torch/csrc/surfelio.cpp``.  ``g++`` builds it at first
use into ``build/surfelmapping_tpu_torch/``, named with a digest of the
source and the flags (as ops/cuda_lib.py names the kernels), so an edited
source is rebuilt and a stale library is never loaded.  A library that
cannot be built or loaded raises with the compiler's or the loader's
message: nothing here falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from ..ops.cuda_lib import BUILD_DIR, CSRC_DIR

SOURCE = CSRC_DIR / "surfelio.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-lpng", "-lz", "-lpthread")

_c = ctypes
_BYTES = _c.POINTER(_c.c_ubyte)
_INT = _c.POINTER(_c.c_int)
_FUNCTIONS = {
    "sm_read_png": (_c.c_int, [_c.c_char_p, _c.POINTER(_BYTES), _INT, _INT, _INT, _INT]),
    "sm_free": (None, [_c.c_void_p]),
    "sm_loader_create": (_c.c_void_p, [_c.c_char_p, _c.c_char_p, _c.c_char_p, _c.c_int,
                                       _c.c_int, _c.c_int, _c.c_int]),
    "sm_loader_get": (_c.c_int, [_c.c_void_p, _c.c_int, _c.POINTER(_c.c_void_p),
                                 _c.POINTER(_BYTES), _INT, _INT, _INT,
                                 _c.POINTER(_BYTES), _INT, _INT, _INT,
                                 _c.POINTER(_BYTES), _INT, _INT]),
    "sm_frame_free": (None, [_c.c_void_p]),
    "sm_loader_destroy": (None, [_c.c_void_p]),
    "sm_save_map": (_c.c_int, [_c.c_char_p, _c.POINTER(_c.c_float), _c.c_uint, _c.c_int,
                               _c.c_int]),
    "sm_load_map": (_c.c_int, [_c.c_char_p, _c.POINTER(_c.POINTER(_c.c_float)),
                               _c.POINTER(_c.c_uint), _INT, _INT]),
}


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode()
    ).hexdigest()[:12]
    return BUILD_DIR / f"libsurfelio-{digest}.so"


def missing_toolchain() -> str | None:
    """Why the library cannot be built on this machine (no ``g++``, or no
    libpng header), or None if it can: the preprocessor is asked for
    ``<png.h>``.  A caller that picks a decoder per machine asks this first."""
    cxx = shutil.which("g++")
    if cxx is None:
        return "no g++ on PATH"
    proc = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                          input="#include <png.h>\n", capture_output=True, text=True)
    return None if proc.returncode == 0 else proc.stderr.strip()


def build() -> Path:
    """Build the library if it is not built yet; raises with g++'s output."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"cannot build {SOURCE.name}: no g++ on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    path = build()
    try:
        handle = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    for name, (restype, argtypes) in _FUNCTIONS.items():
        fn = getattr(handle, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return handle


def _copy(ptr, nbytes: int) -> np.ndarray:
    return np.frombuffer(_c.cast(ptr, _c.POINTER(_c.c_ubyte * nbytes)).contents,
                         np.uint8).copy()


def read_png(path: str) -> np.ndarray:
    """Decode a PNG natively: u8[H,W] / u8[H,W,3] / u16[H,W]."""
    L = lib()
    data = _BYTES()
    w, h, ch, bd = _c.c_int(), _c.c_int(), _c.c_int(), _c.c_int()
    rc = L.sm_read_png(path.encode(), _c.byref(data), _c.byref(w), _c.byref(h),
                       _c.byref(ch), _c.byref(bd))
    if rc != 0:
        raise FileNotFoundError(f"{path}: not a readable PNG")
    try:
        buf = _copy(data, w.value * h.value * ch.value * (bd.value // 8))
    finally:
        L.sm_free(data)
    arr = (buf.view("<u2") if bd.value == 16 else buf).reshape(h.value, w.value, ch.value)
    return arr[:, :, 0] if ch.value == 1 else arr


class FramePrefetcher:
    """Background-threaded (rgb, depth, semantic) PNG triple loader keeping
    ``queue_depth`` frames decoded ahead of the consumer.  Frames are taken
    once each, by id, within [first_id, last_id]."""

    def __init__(self, rgb_dir: str, depth_dir: str, sem_dir: str,
                 first_id: int, last_id: int, n_threads: int = 2,
                 queue_depth: int = 8):
        self._lib = lib()
        self.first_id, self.last_id = first_id, last_id
        self._taken: set[int] = set()
        self._h = self._lib.sm_loader_create(
            rgb_dir.encode(), depth_dir.encode(), sem_dir.encode(),
            first_id, last_id, n_threads, queue_depth,
        )
        if not self._h:
            raise RuntimeError("native frame loader creation failed")

    def get(self, frame_id: int):
        """Returns (rgb u8[H,W,3], depth u16[H,W], semantic u8[H,W]); raises
        if a file of the frame cannot be decoded."""
        # the loader waits for a frame no worker will decode: refuse those
        if not self._h:
            raise RuntimeError("the frame loader is closed")
        if not self.first_id <= frame_id <= self.last_id or frame_id in self._taken:
            raise ValueError(f"frame {frame_id} is not pending in "
                             f"[{self.first_id}, {self.last_id}]")
        self._taken.add(frame_id)
        fh = _c.c_void_p()
        prgb, pdep, psem = _BYTES(), _BYTES(), _BYTES()
        rw, rh, rch = _c.c_int(), _c.c_int(), _c.c_int()
        dw, dh, dbits = _c.c_int(), _c.c_int(), _c.c_int()
        sw, sh = _c.c_int(), _c.c_int()
        rc = self._lib.sm_loader_get(
            self._h, frame_id, _c.byref(fh),
            _c.byref(prgb), _c.byref(rw), _c.byref(rh), _c.byref(rch),
            _c.byref(pdep), _c.byref(dw), _c.byref(dh), _c.byref(dbits),
            _c.byref(psem), _c.byref(sw), _c.byref(sh),
        )
        if rc != 0:
            raise RuntimeError(f"frame {frame_id} failed to decode (rc={rc})")
        try:
            rgb = _copy(prgb, rw.value * rh.value * rch.value).reshape(
                rh.value, rw.value, rch.value)
            depth = _copy(pdep, dw.value * dh.value * (dbits.value // 8))
            depth = (depth.view("<u2") if dbits.value == 16
                     else depth.astype(np.uint16)).reshape(dh.value, dw.value)
            sem = _copy(psem, sw.value * sh.value).reshape(sh.value, sw.value)
        finally:
            self._lib.sm_frame_free(fh)
        return rgb, depth, sem

    def close(self) -> None:
        """Stop the decoding threads and free the pending frames."""
        if self._h:
            self._lib.sm_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        if getattr(self, "_h", None):
            self.close()


def save_map_native(path: str, records: np.ndarray, start_id: int, end_id: int) -> None:
    """Write f32[N,12] records in the reference's map format."""
    rec = np.ascontiguousarray(records, dtype=np.float32)
    if rec.ndim != 2 or rec.shape[1] != 12:
        raise ValueError(f"records must be [N, 12], got {rec.shape}")
    rc = lib().sm_save_map(path.encode(), rec.ctypes.data_as(_c.POINTER(_c.c_float)),
                           rec.shape[0], start_id, end_id)
    if rc != 0:
        raise IOError(f"sm_save_map({path}) rc={rc}")


def load_map_native(path: str) -> tuple[np.ndarray, int, int]:
    """Read a reference-format map: (f32[N,12] records, start_id, end_id)."""
    L = lib()
    rec = _c.POINTER(_c.c_float)()
    count, s0, s1 = _c.c_uint(), _c.c_int(), _c.c_int()
    rc = L.sm_load_map(path.encode(), _c.byref(rec), _c.byref(count),
                       _c.byref(s0), _c.byref(s1))
    if rc != 0:
        raise IOError(f"sm_load_map({path}) rc={rc}")
    try:
        n = count.value
        arr = (np.frombuffer(_c.cast(rec, _c.POINTER(_c.c_float * (n * 12))).contents,
                             np.float32).copy().reshape(n, 12)
               if n else np.zeros((0, 12), np.float32))
    finally:
        L.sm_free(rec)
    return arr, s0.value, s1.value
