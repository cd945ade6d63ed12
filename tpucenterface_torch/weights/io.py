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

`save_packed_weights` / `load_packed_weights` write and read the packed
deployment artifact of a quantized Detector (`tpucenterface/weights/io.py:
171-307`), one `.npz` in the JAX package's layout, so either package loads
what the other wrote:

    manifest   JSON as uint8: weight_bits, int8_dw, packed {tag: {path,
               shape}}, leaves {"p/<path>": {path, dtype}}, act [tags]
    g/<tag>    each quantized kernel's grid indices + qmax as uint8, two to
               a byte (high nibble first) at weight_bits <= 4
    s/<tag>    its per-output-channel scales, float32
    p/<path>   every other leaf as stored (bfloat16 leaves as float32)
    a/<tag>    the activation scales, float64
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


def save_packed_weights(det, path: str) -> Dict[str, int]:
    """Pack a quantize()d Detector's serving weights into one .npz (see the
    module docstring): every kernel the quant forward quantizes as its grid
    indices with its scale frozen beside it, the biases and other leaves
    raw. Every process that loads the artifact serves the same program
    (frozen "w:<tag>" scales make round(k / s) reproduce the grid); against
    the packed Detector it is bit-equal where the scales were frozen already
    (AdaRound) and equal to float dust elsewhere. Not a training
    checkpoint: the float kernels are not recoverable.

    Returns {"packed_bytes": size of the file, "f32_bytes": the params'
    float32 footprint}."""
    import io as _io

    from tpucenterface_torch.quant.adaround import _kernel_paths
    from tpucenterface_torch.train.step import tree_paths

    eng = getattr(det, "_quant", None)
    if eng is None:
        raise ValueError("save_packed_weights requires a quantize()d detector")
    qmax = eng.wqmax
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {
        "weight_bits": eng.weight_bits,
        "int8_dw": int(eng.int8_dw),
        "packed": {},
        "leaves": {},
        "act": sorted(eng.act_scales or {}),
    }
    flat = {p: t.detach().cpu().numpy() for p, t in tree_paths(eng.p)}
    packed_paths = set()
    for tag, kp in _kernel_paths(eng).items():
        if not eng.quantizes(tag) or kp not in flat:
            continue
        node = flat[kp]
        packed_paths.add(kp)
        kq, sw = eng.quant_weight(tag)  # the installed weights' own rule
        u = (kq.astype(np.int16) + qmax).astype(np.uint8).reshape(-1)  # [0, 2 * qmax]
        if eng.weight_bits <= 4:
            if u.size % 2:
                u = np.concatenate([u, np.zeros(1, np.uint8)])
            u = (u[0::2] << 4) | u[1::2]
        arrays[f"g/{tag}"] = u
        arrays[f"s/{tag}"] = sw.astype(np.float32)
        manifest["packed"][tag] = {"path": list(kp), "shape": list(node.shape)}
    for kp, node in flat.items():
        if kp in packed_paths:
            continue
        key = "p/" + "/".join(kp)
        manifest["leaves"][key] = {"path": list(kp), "dtype": str(node.dtype)}
        arrays[key] = node
    for tag, v in (eng.act_scales or {}).items():
        arrays[f"a/{tag}"] = np.asarray(v, np.float64)
    arrays["manifest"] = np.frombuffer(json.dumps(manifest).encode(), np.uint8).copy()
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    data = buf.getvalue()
    with open(path, "wb") as f:
        f.write(data)
    f32_bytes = sum(int(np.prod(v.shape)) * 4 for v in flat.values())
    return {"packed_bytes": len(data), "f32_bytes": f32_bytes}


def load_packed_weights(path: str):
    """Inverse of `save_packed_weights` (either package's) -> (scales,
    quant_params) for `Detector.quantize(scales=scales,
    quant_params=quant_params)`: the scales carry weight_bits, int8_dw and
    the frozen "w:<tag>" weight scales. Neither the card nor the port has
    `ml_dtypes`, so a leaf whose manifest dtype is "bfloat16" loads as
    float32 values, each exact in bf16 (the artifact stores them so)."""
    from tpucenterface_torch.train.step import tree_build

    z = np.load(path)
    manifest = json.loads(bytes(z["manifest"]).decode())
    bits = manifest["weight_bits"]
    qmax = 2 ** (bits - 1) - 1
    flat: Dict[tuple, np.ndarray] = {}
    scales: Dict[str, Any] = {}
    for tag, info in manifest["packed"].items():
        shape = tuple(info["shape"])
        u = z[f"g/{tag}"]
        if bits <= 4:
            u = np.stack([(u >> 4) & 0xF, u & 0xF], axis=-1).reshape(-1)
        g = u[: int(np.prod(shape))].astype(np.int16) - qmax
        sw = z[f"s/{tag}"].astype(np.float64)
        flat[tuple(info["path"])] = (g.reshape(shape).astype(np.float64) * sw).astype(np.float32)
        scales[f"w:{tag}"] = sw.astype(np.float32)
    for key, info in manifest["leaves"].items():
        arr = z[key]
        flat[tuple(info["path"])] = arr.astype(np.float32) if info["dtype"] == "bfloat16" else arr
    for tag in manifest["act"]:
        v = z[f"a/{tag}"]
        scales[tag] = v if v.ndim else float(v)
    scales["cfg:weight_bits"] = bits
    scales["cfg:int8_dw"] = int(manifest["int8_dw"])
    return scales, tree_build(list(flat), list(flat.values()))
