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

`mbconv_args_from_block` cuts one folded inverted-residual block into the
arguments of `ops.fused_mbconv` (`tpucenterface/model/fast_forward.py:129-147`
without its channel padding); `chain_blocks_from_run` turns a run of them into
the block list of `ops.planar_mbconv.planar_mbconv_chain`
(`tpucenterface/model/planar_engine.py:164-173,218-227`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


MBConvArgs = Tuple[
    Optional[np.ndarray], Optional[np.ndarray], np.ndarray, np.ndarray, np.ndarray, np.ndarray
]


def mbconv_args_from_block(block: Mapping[str, Any]) -> MBConvArgs:
    """One folded flax block ({'expand'?, 'depthwise', 'project'} ->
    'conv' -> 'kernel' HWIO, 'bias') -> (w1 (Cin, Ce), b1, wd (3, 3, Ce), bd,
    w2 (Ce, Cout), b2) as float32 numpy; w1 and b1 are None when the block
    has no expand. A 1x1 HWIO kernel (1, 1, I, O) is already input-major, so
    it is sliced and not transposed."""

    def conv(name):
        node = block[name]["conv"]
        if "bias" not in node:
            raise ValueError(f"block scope '{name}' has no folded bias; fold BatchNorm first")
        return np.asarray(node["kernel"], np.float32), np.asarray(node["bias"], np.float32)

    w1 = b1 = None
    if "expand" in block:
        k, b1 = conv("expand")
        w1 = np.ascontiguousarray(k[0, 0])
    k, bd = conv("depthwise")
    wd = np.ascontiguousarray(k[:, :, 0, :])
    k, b2 = conv("project")
    return w1, b1, wd, bd, np.ascontiguousarray(k[0, 0]), b2


def chain_blocks_from_run(blocks: Sequence[Mapping[str, Any]], cin: int) -> List[Dict[str, Any]]:
    """A run of consecutive folded stride-1 flax blocks, entered with `cin`
    channels -> the chain's block list: {w1, b1, wd, bd, w2, b2} as
    `mbconv_args_from_block` gives them (float32 numpy) and `skip`, true where
    a block's output is as wide as its input."""
    run = []
    for block in blocks:
        args = mbconv_args_from_block(block)
        cout = args[4].shape[1]
        run.append({**dict(zip(("w1", "b1", "wd", "bd", "w2", "b2"), args)), "skip": cin == cout})
        cin = cout
    return run
