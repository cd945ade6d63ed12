"""Host (C++) staging kernel of the port: the stem's uint8 -> int8 table
applied while a launch buffer is assembled.

Mirrors `tpucenterface/native/__init__.py::stem_lut_apply` and its build
(`_build_and_load_stage`), on the port's own copy of `stage_ext.cpp`. The
library is compiled at first use with

    g++ -O3 -shared -fPIC stage_ext.cpp -lpthread

into `build/native/` at the repository root (ignored by git), named by a hash
of the source, the flags, the compiler's version and the host, so a library
built on one machine is never loaded on another; the build writes a
per-process temporary and renames it into place. A failed build or load
raises: nothing falls back to the numpy loop (`quant.engine.apply_stem_lut`,
which stays the plain version the tests hold this kernel to).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "stage_ext.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _compiler_version() -> str:
    r = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    return r.stdout


def library_path() -> Path:
    """Where the library for this source, these flags, this compiler and
    this host lives (built or not)."""
    key = b"\0".join((
        SOURCE.read_bytes(), " ".join(GXX_FLAGS).encode(), _compiler_version().encode(),
        platform.platform().encode(), platform.node().encode(),
    ))
    return BUILD_DIR / f"stage_ext-{hashlib.sha256(key).hexdigest()[:16]}.so"


def load() -> ctypes.CDLL:
    """The loaded staging library, built first if need be; raises when g++
    is missing or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            r = subprocess.run(
                ["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp), "-lpthread"],
                capture_output=True, text=True, timeout=120,
            )
            if r.returncode != 0:
                raise RuntimeError(f"g++ failed for {SOURCE.name} (rc {r.returncode}):\n{r.stdout}{r.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        lib.stem_lut_apply.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.stem_lut_apply.restype = None
        _lib = lib
        return lib


def stem_lut_apply(
    imgs_u8: np.ndarray,
    lut: np.ndarray,
    out: Optional[np.ndarray] = None,
    nthreads: int = 0,
) -> np.ndarray:
    """(..., 3) uint8 -> int8 through a (256, 3) int8 table, threaded C++.

    `out` (the same shape, int8, C-contiguous: a leading-axis slice of a
    coalesced launch buffer, say) lets the serving assembly write straight
    into the batch buffer. nthreads=0 uses the host's CPU count."""
    lib = load()
    src = np.ascontiguousarray(imgs_u8)
    table = np.ascontiguousarray(lut)
    if src.dtype != np.uint8 or src.ndim < 1 or src.shape[-1] != 3:
        raise ValueError(f"expected (..., 3) uint8 images, got {src.dtype} {src.shape}")
    if table.dtype != np.int8 or table.shape != (256, 3):
        raise ValueError(f"expected a (256, 3) int8 table, got {table.dtype} {table.shape}")
    if out is None:
        dst = np.empty(src.shape, np.int8)
    else:
        if out.shape != src.shape or out.dtype != np.int8 or not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous int8 of the images' shape")
        dst = out
    if nthreads <= 0:
        nthreads = os.cpu_count() or 1
    if src.size:
        lib.stem_lut_apply(src.ctypes.data, src.size // 3, table.ctypes.data, dst.ctypes.data, nthreads)
    return dst
