"""ctypes bindings for the native PNG decoder / prefetching frame loader
(port of vo_tpu/runtime/loader.py).

Builds `libvopng.so` from `runtime/native/pngloader.cpp` with g++ on first
use, into the git-ignored `vo_tpu_torch/_build/` (rebuilt when the source
is newer). The build writes a file of its own name and renames it into
place, so processes that build at once never load half a library. The
decoder needs g++, zlib's header `zlib.h` and its library (`-lz`);
`native_available()` is False without them and `build_error()` says why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "pngloader.cpp")
_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_LIB = os.path.join(_BUILD_DIR, "libvopng.so")

_lock = threading.Lock()
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    """Compile the shared library; returns an error string or None."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", tmp,
           "-lz", "-lpthread"]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ could not run ({type(e).__name__}: {e})"
    if r.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return ("g++ failed (the decoder needs g++, zlib.h and -lz): "
                + r.stderr[-2000:])
    os.replace(tmp, _LIB)
    return None


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            err = _build()
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(_LIB)
        lib.vo_png_decode.restype = ctypes.c_int
        lib.vo_png_decode.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vo_loader_create.restype = ctypes.c_void_p
        lib.vo_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.vo_loader_get.restype = ctypes.c_int
        lib.vo_loader_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.vo_loader_destroy.restype = None
        lib.vo_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def build_error() -> str | None:
    _load()
    return _build_error


def decode_png(path: str, max_pixels: int = 16_000_000) -> np.ndarray:
    """Decode one PNG to float32 (H, W) grayscale via the native library."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    out = np.empty(max_pixels, np.float32)
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.vo_png_decode(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        max_pixels,
        ctypes.byref(h),
        ctypes.byref(w),
    )
    if rc != 0:
        raise IOError(f"vo_png_decode({path}) failed with code {rc}")
    return out[: h.value * w.value].reshape(h.value, w.value).copy()


class NativePrefetcher:
    """Ordered frame stream with background decode threads.

    Usage: `with NativePrefetcher(paths) as p: img = p.get(i)`. Frames are
    decoded up to `ring` ahead of the consumer, so decode overlaps device
    compute (the reference decodes synchronously in the frame loop,
    feature_tracking.cpp:57/:64). `served` counts the frames returned."""

    def __init__(
        self,
        paths: list[str],
        n_threads: int = 4,
        ring: int = 16,
        max_pixels: int = 16_000_000,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.vo_loader_create(
            arr, len(self._paths), n_threads, ring
        )
        self._max_pixels = max_pixels
        self.served = 0

    def get(self, idx: int) -> np.ndarray:
        out = np.empty(self._max_pixels, np.float32)
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.vo_loader_get(
            self._handle,
            idx,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._max_pixels,
            ctypes.byref(h),
            ctypes.byref(w),
        )
        if rc != 0:
            raise IOError(f"vo_loader_get({idx}) failed with code {rc}")
        self.served += 1
        return out[: h.value * w.value].reshape(h.value, w.value).copy()

    def close(self):
        if self._handle:
            self._lib.vo_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "_handle", None):  # __init__ may have raised
            self.close()
