"""Host (C++) kernels of the port: the stem's uint8 -> int8 table applied
while a launch buffer is assembled, and the eval path's IoU matrix and
greedy NMS.

Mirrors `tpucenterface/native/__init__.py` (`stem_lut_apply`,
`bbox_overlaps`, `nms`, `available`, `stage_available` and their builds) on
the port's own copies of `stage_ext.cpp` and `nms_ext.cpp`. Each library is
compiled at first use with

    g++ -O3 -shared -fPIC <source>.cpp -lpthread

into `build/native/` at the repository root (ignored by git), named by a hash
of the source, the flags, the compiler's version and the host, so a library
built on one machine is never loaded on another; the build writes a
per-process temporary and renames it into place. A failed build or load
raises (`available` and `stage_available` answer False instead): nothing
falls back to a numpy loop (`quant.engine.apply_stem_lut_plain`,
`eval.wider_eval.bbox_overlaps_plain` and `eval.tta.nms_plain` stay the plain
versions the tests hold these kernels to).
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

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "stage_ext.cpp"
NMS_SOURCE = HERE / "nms_ext.cpp"
BUILD_DIR = HERE.parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

# one lock a library, so that the two build side by side
_lock = threading.Lock()
_nms_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_nms_lib: Optional[ctypes.CDLL] = None


def _compiler_version() -> str:
    r = subprocess.run(["g++", "--version"], capture_output=True, text=True, check=True)
    return r.stdout


def _library_path(source: Path) -> Path:
    key = b"\0".join((
        source.read_bytes(), " ".join(GXX_FLAGS).encode(), _compiler_version().encode(),
        platform.platform().encode(), platform.node().encode(),
    ))
    return BUILD_DIR / f"{source.stem}-{hashlib.sha256(key).hexdigest()[:16]}.so"


def library_path() -> Path:
    """Where the staging library for this source, these flags, this compiler
    and this host lives (built or not)."""
    return _library_path(SOURCE)


def _build_and_load(source: Path) -> ctypes.CDLL:
    out = _library_path(source)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run(
            ["g++", *GXX_FLAGS, str(source), "-o", str(tmp), "-lpthread"],
            capture_output=True, text=True, timeout=120,
        )
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed for {source.name} (rc {r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def load() -> ctypes.CDLL:
    """The loaded staging library, built first if need be; raises when g++
    is missing or fails."""
    global _lib
    with _lock:
        if _lib is None:
            lib = _build_and_load(SOURCE)
            lib.stem_lut_apply.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ]
            lib.stem_lut_apply.restype = None
            _lib = lib
        return _lib


def load_nms() -> ctypes.CDLL:
    """The loaded eval library (`bbox_overlaps`, `nms`), built first if need
    be; raises when g++ is missing or fails."""
    global _nms_lib
    with _nms_lock:
        if _nms_lib is None:
            lib = _build_and_load(NMS_SOURCE)
            lib.bbox_overlaps.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.bbox_overlaps.restype = None
            lib.nms.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_void_p]
            lib.nms.restype = ctypes.c_int64
            _nms_lib = lib
        return _nms_lib


def available() -> bool:
    """Whether the eval library builds and loads here."""
    try:
        load_nms()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def stage_available() -> bool:
    """Whether the staging library builds and loads here. As the JAX
    function does, it answers False where the build or load fails;
    `stem_lut_apply` raises on the same failure."""
    try:
        load()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


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


def _rows(a: np.ndarray, width: int, dtype, what: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"expected ({what}) rows of {width}, got {a.shape}")
    return a


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """C++ IoU matrix (N, M) in float64 of xyxy boxes, +1 pixel convention."""
    lib = load_nms()
    b = _rows(boxes, 4, np.float64, "N boxes")
    q = _rows(query, 4, np.float64, "M boxes")
    out = np.empty((len(b), len(q)), np.float64)
    if len(b) and len(q):
        lib.bbox_overlaps(b.ctypes.data, len(b), q.ctypes.data, len(q), out.ctypes.data)
    return out


def nms(dets_sorted: np.ndarray, thresh: float) -> np.ndarray:
    """C++ greedy NMS over score-descending (N, 5) xyxy+score detections,
    computed in float32; returns the kept row indices (int64)."""
    lib = load_nms()
    d = _rows(dets_sorted, 5, np.float32, "N detections")
    keep = np.empty(len(d), np.int64)
    n = lib.nms(d.ctypes.data, len(d), thresh, keep.ctypes.data) if len(d) else 0
    return keep[:n]
