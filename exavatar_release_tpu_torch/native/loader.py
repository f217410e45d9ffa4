"""ctypes bindings and build driver for the native data loader (counterpart
of exavatar_release_tpu/native/loader.py).

The shared library is built at first use from ``dataloader.cpp`` beside this
file, with g++ and the system zlib, into ``build/native/`` at the root of the
checkout (listed in ``.gitignore``), under a name that hashes the source and
the command; nothing is built when the module is imported. Where it cannot
be built, ``native_available()`` is False and ``NativeLoader`` raises; the
callers decide whether another decoder may stand in (see data/subject.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import os.path as osp
import subprocess
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

_DIR = osp.dirname(osp.abspath(__file__))
_SRC = osp.join(_DIR, "dataloader.cpp")
BUILD_DIR = osp.join(osp.dirname(osp.dirname(_DIR)), "build", "native")
_FLAGS = ("-O3", "-shared", "-fPIC")
_LIBS = ("-lz", "-lpthread")
_lib = None
_build_error: Optional[str] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS + _LIBS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return osp.join(BUILD_DIR, f"libexavatar_loader-{h.hexdigest()[:16]}.so")


def build_native(force: bool = False) -> Optional[str]:
    """Compile the shared library unless it is there (or ``force``). Returns
    its path, or None when g++ or zlib is missing (``build_error()`` says
    why)."""
    global _build_error
    path = library_path()
    if osp.exists(path) and not force:
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp, *_LIBS], check=True,
                       capture_output=True, text=True)
    except FileNotFoundError as e:
        _build_error = str(e)
        return None
    except subprocess.CalledProcessError as e:
        _build_error = e.stderr
        return None
    os.replace(tmp, path)
    return path


def build_error() -> Optional[str]:
    """The compiler's message when the last build failed."""
    return _build_error


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    path = build_native()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.exa_loader_create.restype = ctypes.c_void_p
    lib.exa_loader_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.exa_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.exa_loader_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
    lib.exa_loader_wait.restype = ctypes.c_int64
    lib.exa_loader_wait.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.exa_loader_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.exa_decode_png.restype = ctypes.c_int
    lib.exa_decode_png.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    _lib = lib
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def _require_lib():
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: building {_SRC} failed: {_build_error}")
    return lib


def decode_png_native(path: str, max_pixels: int = 1 << 24) -> Optional[np.ndarray]:
    """One PNG as (C, H, W) float32 in [0, 1] (C = 1 gray, 2 gray+alpha, 3
    RGB, 4 RGBA; 8-bit, not interlaced, no palette), or None when the
    decoder does not take the file. Raises when the library cannot be built."""
    lib = _require_lib()
    buf = np.empty((4 * max_pixels,), np.float32)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.exa_decode_png(path.encode(), buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c))
    if rc != 0:
        return None
    n = c.value * h.value * w.value
    return buf[:n].reshape(c.value, h.value, w.value).copy()


class NativeLoader:
    """Prefetching loader: submit paths, then take decoded (C, H, W) float
    images in completion order as (id, array)."""

    def __init__(self, num_threads: int = 8, queue_cap: int = 16):
        self._lib = _require_lib()
        self._h = self._lib.exa_loader_create(num_threads, queue_cap)

    def close(self):
        if self._h:
            self._lib.exa_loader_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def submit(self, idx: int, path: str):
        self._lib.exa_loader_submit(self._h, idx, path.encode())

    def wait(self) -> Tuple[int, Optional[np.ndarray]]:
        """(id, image); (-2, None) for a file the decoder did not take,
        (-1, None) once the loader is closed and drained."""
        w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        rid = self._lib.exa_loader_wait(self._h, ctypes.byref(w), ctypes.byref(h),
                                        ctypes.byref(c))
        if rid < 0:
            return int(rid), None
        out = np.empty((c.value, h.value, w.value), np.float32)
        self._lib.exa_loader_copy(self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return int(rid), out

    def map(self, paths: Sequence[str]) -> Dict[int, np.ndarray]:
        """Decode a batch of paths with full pipeline overlap."""
        for i, p in enumerate(paths):
            self.submit(i, p)
        out: Dict[int, np.ndarray] = {}
        for _ in paths:
            rid, arr = self.wait()
            if rid >= 0 and arr is not None:
                out[rid] = arr
        return out
