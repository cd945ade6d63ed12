"""Safetensors reading and writing with numpy alone.

Mirrors `tpucenterface/weights/io.py::load_safetensors` and
`::save_safetensors`, which use the `safetensors` package; that package is not
installed everywhere the port runs, so this module reads and writes the
format itself:

    8 bytes   little-endian u64: length N of the JSON header
    N bytes   JSON: {name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}
              (+ an optional "__metadata__" entry)
    rest      the tensors' raw little-endian bytes, offsets relative to here

Keys are '/'-joined flax paths ('params/backbone/stem/conv/kernel'), split
back into the nested {'params': ..., 'batch_stats': ...} tree. The writer
lays the tensors out back to back in sorted key order and pads the header
with spaces to a multiple of 8 bytes, as the `safetensors` package does, so
that package reads what the port writes.

`save_quant_scales` / `load_quant_scales` persist a quantized Detector's
scales as JSON (`tpucenterface/weights/io.py:141-168`): floats for per-tensor
entries, lists for the per-channel depthwise ones.
"""

from __future__ import annotations

import json
import struct
from typing import Any, Dict

import numpy as np
import torch

_DTYPES = {
    "F64": "<f8",
    "F32": "<f4",
    "F16": "<f2",
    "I64": "<i8",
    "I32": "<i4",
    "I16": "<i2",
    "I8": "i1",
    "U8": "u1",
    "BOOL": "?",
}


_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def flatten(tree: Dict[str, Any], sep: str = "/") -> Dict[str, Any]:
    """{'a': {'b': {'c': v}}} -> {'a/b/c': v}."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}{sep}{kk}": vv for kk, vv in flatten(v, sep).items()})
        else:
            out[k] = v
    return out


def save_safetensors(variables: Dict[str, Any], path: str) -> None:
    """Write a nested {'params': ..., 'batch_stats': ...} tree (numpy arrays
    or tensors, any device) with '/'-joined keys, the layout
    `load_safetensors` and the JAX package's `load_safetensors` read."""
    arrays = {}
    for key, v in flatten(variables).items():
        a = np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor) else v)
        if a.dtype not in _NAMES:
            raise ValueError(f"tensor {key} has unsupported dtype {a.dtype}")
        arrays[key] = a if a.flags.c_contiguous else a.copy(order="C")
    header, offset = {}, 0
    for key in sorted(arrays):
        a = arrays[key]
        header[key] = {"dtype": _NAMES[a.dtype], "shape": list(a.shape), "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for key in sorted(arrays):
            f.write(arrays[key].tobytes())


def read_safetensors_flat(path: str) -> Dict[str, np.ndarray]:
    """{key: array} of every tensor in the file, keys as stored."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", data[:8])
    if 8 + n > len(data):
        raise ValueError(f"{path}: header length {n} runs past the file end")
    header = json.loads(data[8 : 8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n :]
    out: Dict[str, np.ndarray] = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dt = _DTYPES.get(info["dtype"])
        if dt is None:
            raise ValueError(f"{path}: tensor {key} has unsupported dtype {info['dtype']}")
        begin, end = info["data_offsets"]
        shape = tuple(int(d) for d in info["shape"])
        dtype = np.dtype(dt)
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * dtype.itemsize or end > len(body):
            raise ValueError(f"{path}: tensor {key} has inconsistent data_offsets")
        arr = np.frombuffer(body[begin:end], dtype=dtype, count=count)
        out[key] = arr.reshape(shape).astype(dtype.newbyteorder("="), copy=True)
    return out


def unflatten(flat: Dict[str, Any], sep: str = "/") -> Dict[str, Any]:
    """{'a/b/c': v} -> {'a': {'b': {'c': v}}}."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def load_safetensors(path: str) -> Dict[str, Any]:
    """Nested {'params': ..., 'batch_stats': ...} tree of numpy arrays."""
    return unflatten(read_safetensors_flat(path))


def save_quant_scales(scales: Dict[str, Any], path: str) -> None:
    """Persist `Detector.quantize()` scales as JSON: per-tensor entries as
    floats, per-channel (int8_dw depthwise) entries as lists. Calibrate once,
    save, then `det.quantize(scales=load_quant_scales(path))` everywhere."""
    out = {k: (v.tolist() if isinstance(v, np.ndarray) else float(v)) for k, v in scales.items()}
    with open(path, "w") as f:
        json.dump(out, f)


def load_quant_scales(path: str) -> Dict[str, Any]:
    """Inverse of `save_quant_scales` (lists come back as float64 arrays)."""
    with open(path) as f:
        raw = json.load(f)
    return {k: (np.asarray(v, np.float64) if isinstance(v, list) else float(v)) for k, v in raw.items()}
