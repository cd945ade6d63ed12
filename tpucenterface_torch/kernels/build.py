"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each `csrc/<name>.cu` is compiled on first use into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

The library goes into `build/kernels/` at the repository root (ignored by git),
named by a hash of the source, the flags and the nvcc version, so an edited
source is rebuilt and an unchanged one is loaded as it is. A failed build or
load raises; nothing falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if need be."""
    nvcc = nvcc_path()
    src = CSRC / f"{name}.cu"
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True).stdout
    key = src.read_bytes() + " ".join(NVCC_FLAGS).encode() + version.encode()
    out = BUILD_DIR / f"{name}-{hashlib.sha256(key).hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        r = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name} (rc {r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
