"""Carry JAX-layout parameters into the port's modules and back.

Mirrors `tpucenterface/weights/port.py::torch_state_from_flax` (and its
inverse `flax_from_torch_state`). A flax path ('params', *modules, leaf)
names the port's module attribute path one for one:

    params/<m...>/conv/kernel      <m...>.conv.weight   HWIO -> OIHW
    params/<m...>/conv/bias        <m...>.conv.bias
    params/<m...>/bn/{scale,bias}  <m...>.bn.{weight,bias}
    batch_stats/<m...>/bn/{mean,var}  <m...>.bn.{running_mean,running_var}

HWIO (kh, kw, I, O) becomes OIHW (O, I, kh, kw); a depthwise (3, 3, 1, C)
kernel becomes (C, 1, 3, 3); the fused heads' block-diagonal 1x1 out kernel is
carried like any other kernel. Values are copied exactly.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from tpucenterface_torch.weights.io import unflatten

_BN_MAP = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
_BN_INV = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path) -> Tuple[str, bool]:
    """flax path -> (port state_dict key, kernel needing HWIO -> OIHW)."""
    col, *mods, leaf = path
    if col == "batch_stats" or (mods and mods[-1] == "bn"):
        return ".".join(mods) + "." + _BN_MAP[leaf], False
    if leaf == "kernel":
        return ".".join(mods) + ".weight", True
    return ".".join(mods) + "." + leaf, False


def state_dict_from_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX-layout {'params': ...[, 'batch_stats': ...]} -> port state_dict."""
    out: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        if col not in variables:
            continue
        for path, leaf in _flatten(variables[col], (col,)):
            key, is_kernel = _torch_key(path)
            w = np.asarray(leaf, np.float32)
            if is_kernel:
                w = np.transpose(w, (3, 2, 0, 1))
            out[key] = torch.from_numpy(np.array(w, order="C"))
    return out


def variables_from_state_dict(state: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """Inverse of `state_dict_from_variables` (port state_dict -> JAX layout)."""
    flat: Dict[str, np.ndarray] = {}
    for key, t in state.items():
        *mods, leaf = key.split(".")
        if leaf == "num_batches_tracked":
            continue
        w = t.detach().cpu().float().numpy()
        if mods[-1] == "bn":
            col = "batch_stats" if leaf.startswith("running_") else "params"
            path = [col, *mods, _BN_INV[leaf]]
        elif leaf == "weight":
            path = ["params", *mods, "kernel"]
            w = np.transpose(w, (2, 3, 1, 0))
        else:
            path = ["params", *mods, leaf]
        flat["/".join(path)] = np.ascontiguousarray(w)
    return unflatten(flat)
