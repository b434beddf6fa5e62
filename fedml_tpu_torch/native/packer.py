"""ctypes binding for the native row-gather packer (``packer.cpp``).

The shared library is compiled with the system ``g++`` the first time it
is needed, into ``build/native/`` at the root of the checkout
(git-ignored), and rebuilt when ``packer.cpp`` is newer.  If no compiler
is present or the build fails, ``gather_rows`` uses the numpy fallback
and ``native_available()`` is false: the native path is a speed-up, and
a caller that must not run without it checks that.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "packer.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_LIB = BUILD_DIR / "libpacker.so"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    # compile to a process-unique path and rename into place: concurrent
    # processes (pytest-xdist workers) must never dlopen a half-written .so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _LIB.with_suffix(f".tmp.{os.getpid()}.so")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-pthread", str(_SRC), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("FEDML_TPU_NO_NATIVE"):
            return None
        try:
            stale = (not _LIB.exists()) or (
                _SRC.stat().st_mtime > _LIB.stat().st_mtime)
            if stale and not _build():
                return None
            lib = ctypes.CDLL(str(_LIB))
            lib.gather_rows.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int32,
            ]
            lib.gather_rows.restype = None
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def native_available() -> bool:
    """True when the compiled gather is loaded (built here if needed)."""
    return _load() is not None


def gather_rows(
    src: np.ndarray,
    idx: np.ndarray,
    out: Optional[np.ndarray] = None,
    *,
    n_threads: int = 0,
) -> np.ndarray:
    """``out[i] = src[idx[i]]`` over leading-axis rows.

    ``src`` must be C-contiguous (it is copied otherwise); ``idx`` is any
    integer array (flattened).  ``out``, if given, must be C-contiguous
    with shape ``(idx.size, *src.shape[1:])`` and ``src``'s dtype.
    ``n_threads=0`` picks the hardware count.  Returns ``out``."""
    if not src.flags.c_contiguous:
        src = np.ascontiguousarray(src)
    flat_idx = np.ascontiguousarray(idx, dtype=np.int64).ravel()
    out_shape = (flat_idx.size, *src.shape[1:])
    if out is None:
        out = np.empty(out_shape, dtype=src.dtype)
    else:
        if out.shape != out_shape or out.dtype != src.dtype:
            raise ValueError(
                f"out has shape {out.shape}/{out.dtype}, "
                f"need {out_shape}/{src.dtype}")
        if not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous")

    lib = _load()
    if lib is None or src.size == 0 or flat_idx.size == 0:
        if flat_idx.size:
            np.take(src, np.clip(flat_idx, 0, src.shape[0] - 1), axis=0, out=out)
        return out

    row_bytes = src.dtype.itemsize * int(np.prod(src.shape[1:], dtype=np.int64))
    lib.gather_rows(
        src.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_int64(src.shape[0]),
        flat_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.c_char_p),
        ctypes.c_int64(flat_idx.size),
        ctypes.c_int64(row_bytes),
        ctypes.c_int32(n_threads),
    )
    return out
