"""ctypes bindings for the native C++ dataset runtime (native/orbtpu_io.cpp).

Gives the dataset path the same native treatment the reference's IO has
(cv::imread + example-main loops are C++): libpng decode + background
prefetch threads, so image decode overlaps device compute. The shared
library is built from `native/Makefile` at first use (needs a C++ compiler
and libpng); `available()` is False where that build cannot run, and
callers fall back to the pure-Python `TUMDataset`.
"""

from __future__ import annotations

import ctypes
import fcntl
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "liborbtpu_io.so"


def _build() -> bool:
    """Run `make -C native` unless the library is newer than its source.

    A lock file serialises concurrent first uses (test workers, tools), so no
    process loads a half-written library."""
    src = _NATIVE_DIR / "orbtpu_io.cpp"
    if not src.is_file():
        return False
    with open(_NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (_LIB_PATH.is_file()
                and _LIB_PATH.stat().st_mtime >= src.stat().st_mtime):
            return True
        try:
            res = subprocess.run(["make", "-C", str(_NATIVE_DIR)],
                                 capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired):
            return False
        return res.returncode == 0 and _LIB_PATH.is_file()


def _load_lib():
    if not _build():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.orbtpu_open_sequence.restype = ctypes.c_void_p
    lib.orbtpu_open_sequence.argtypes = [
        ctypes.c_char_p, ctypes.c_double,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    lib.orbtpu_sequence_shape.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.orbtpu_prefetch.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.orbtpu_read_frame.restype = ctypes.c_int
    lib.orbtpu_read_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.orbtpu_close.argtypes = [ctypes.c_void_p]
    return lib


_LIB = None
_TRIED = False


def get_lib():
    global _LIB, _TRIED
    if not _TRIED:
        _LIB = _load_lib()
        _TRIED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


class NativeTUMDataset:
    """Drop-in for `TUMDataset` with native decode + prefetch."""

    def __init__(self, root: str | Path, depth_factor: float = 5000.0,
                 n_workers: int = 2, prefetch: int = 4):
        lib = get_lib()
        if lib is None:
            raise RuntimeError(
                "liborbtpu_io.so not built; run `make -C native`"
            )
        self._lib = lib
        n = ctypes.c_int(0)
        self._h = lib.orbtpu_open_sequence(
            str(root).encode(), float(depth_factor), ctypes.byref(n), n_workers
        )
        if not self._h:
            raise FileNotFoundError(f"no TUM sequence at {root}")
        self._n = n.value
        h, w = ctypes.c_int(0), ctypes.c_int(0)
        lib.orbtpu_sequence_shape(self._h, ctypes.byref(h), ctypes.byref(w))
        self.height, self.width = h.value, w.value
        self.prefetch_depth = prefetch
        self._lib.orbtpu_prefetch(self._h, 0, prefetch)

    def __len__(self):
        return self._n

    def __getitem__(self, i: int):
        gray = np.empty((self.height, self.width), np.float32)
        depth = np.empty((self.height, self.width), np.float32)
        ts = ctypes.c_double(0.0)
        rc = self._lib.orbtpu_read_frame(
            self._h, int(i),
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            depth.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(ts),
        )
        if rc != 0:
            raise IOError(f"native read_frame({i}) failed: {rc}")
        # keep the pipeline ahead of the consumer
        self._lib.orbtpu_prefetch(self._h, i + 1, self.prefetch_depth)
        # storage dtypes matching the Python loader: u8 gray + f16 depth
        # (a quarter of the host->device bytes of an f32 pair)
        gray8 = gray.astype(np.uint8)
        return ts.value, gray8, (depth.astype(np.float16) if depth.any()
                                 else None)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.orbtpu_close(h)
            self._h = None
