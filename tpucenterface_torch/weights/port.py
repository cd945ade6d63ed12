"""Port torch `.pth` state_dicts into the port's JAX-layout variables.

Mirrors `tpucenterface/weights/port.py`: `flax_from_torch_state`,
`flax_from_torch_module`, `twin_key_order`, `apply_name_map`,
`_ambiguous_unit_pairs`, `propose_name_map`, `flax_from_foreign_state`,
`unwrap_checkpoint` and `load_torch_pth`, each named here with `flax`
replaced by `variables`. Every function returns the numpy tree
{'params': ..., 'batch_stats': ...} that `Detector(variables=...)` takes.
The inverse port is `weights.convert.state_dict_from_variables`, and the
key of a JAX path `weights.convert.torch_key`.

Layout rules:
- Conv weight:  torch (O, I/g, kh, kw)  ->  (kh, kw, I/g, O)  [HWIO]
  (the same transpose covers depthwise convs: (C, 1, k, k) -> (k, k, 1, C))
- BatchNorm:    weight->scale, bias->bias, running_mean->mean, running_var->var
- Biases:       copied as-is.
Values are cast to float32.

The template of the port's network for `cfg` (built on the meta device: no
values, no draws from the random generator) is walked as the source of
truth, in the JAX tree's order: every leaf must find its torch tensor by the
naming contract of `weights.torch_twin`, and its shape after the transpose
must match; a missing key raises KeyError, a wrong shape ValueError, and
extra keys are ignored.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from tpucenterface_torch.config import ModelConfig
from tpucenterface_torch.weights.convert import torch_key, variable_path
from tpucenterface_torch.weights.io import unflatten


def _sorted_paths(tree: Mapping[str, Any], prefix=()):
    """The leaves of a nested dict in flax's order: keys sorted at every level."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _sorted_paths(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


def _template(cfg: ModelConfig):
    """[(JAX path, HWIO shape)] of the port's network for `cfg`, params
    first, then batch_stats, each in flax's order."""
    from tpucenterface_torch.model.centernet import CenterFaceNet

    with torch.device("meta"):
        net = CenterFaceNet(cfg)
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, t in net.state_dict().items():
        path, is_kernel = variable_path(key)
        shape = tuple(t.shape)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = (shape[2], shape[3], shape[1], shape[0]) if is_kernel else shape
    return [(path, shape) for col in ("params", "batch_stats") for path, shape in _sorted_paths(tree[col], (col,))]


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.is_floating_point() else v).numpy()
    return np.asarray(v)


def variables_from_torch_state(state_dict: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Convert a torch state_dict (twin naming contract, `module.` prefixes
    stripped) to JAX-layout variables."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        sd[k] = _to_numpy(v)
    flat = {}
    for path, shape in _template(cfg):
        tk, transpose = torch_key(path)
        if tk not in sd:
            raise KeyError(
                f"torch checkpoint missing '{tk}' (flax path {'/'.join(path)}); "
                f"available keys near it: "
                f"{[k for k in sd if k.split('.')[0] == tk.split('.')[0]][:8]}"
            )
        w = sd[tk]
        if transpose:
            w = np.transpose(w, (2, 3, 1, 0))
        if w.shape != shape:
            raise ValueError(f"shape mismatch for {tk}: torch {w.shape} vs flax {shape} at {'/'.join(path)}")
        flat["/".join(path)] = np.ascontiguousarray(w, np.float32)
    return unflatten(flat)


def variables_from_torch_module(module: torch.nn.Module, cfg: ModelConfig) -> Dict[str, Any]:
    return variables_from_torch_state(module.state_dict(), cfg)


# --------------------------------------------------------------------------- #
# Foreign-checkpoint adapters
# --------------------------------------------------------------------------- #


def twin_key_order(cfg: ModelConfig):
    """The twin naming contract as an ordered [(key, shape)] list (torch
    registration order is network order): the matching target for foreign
    checkpoints. 0-dim entries (num_batches_tracked) are bookkeeping, not
    weights, and are left out."""
    from tpucenterface_torch.weights.torch_twin import TorchCenterFace

    with torch.device("meta"):
        twin = TorchCenterFace(cfg)
    return [(k, tuple(v.shape)) for k, v in twin.state_dict().items() if v.ndim > 0]


def apply_name_map(state_dict: Mapping[str, Any], name_map) -> Dict[str, Any]:
    """Rename checkpoint keys with a declarative (regex, replacement) table.

    Rules apply in order and the first rule whose pattern is found in a key
    wins (re.sub over the whole key). A key whose rule's replacement is None
    is dropped (num_batches_tracked buffers, say)."""
    out: Dict[str, Any] = {}
    for k, v in state_dict.items():
        nk = k
        for pat, repl in name_map:
            if re.search(pat, k):
                nk = None if repl is None else re.sub(pat, repl, k)
                break
        if nk is not None:
            out[nk] = v
    return out


def _ambiguous_unit_pairs(entries):
    """Module units whose ordered shape signatures are identical, adjacent
    or not.

    Positional shape matching cannot verify the order of any two modules
    with the same shape signature (MobileNet's repeated blocks): swapping
    two such units, even with other modules between them, leaves the flat
    shape sequence unchanged, so a foreign net that registered them in
    another order than the twin's data flow would map crosswise with no
    shape mismatch. Scans every module granularity (prefix depth); leaf
    tensors are grouped at least at their parent module (the order weight,
    bias, running_mean, running_var within a module is torch's convention
    and not flagged). Equal-signature units are reported as consecutive
    pairs per signature class."""
    pairs = set()
    if not entries:
        return []
    maxd = max(k.count(".") for k, _ in entries)
    for d in range(1, maxd + 1):
        groups: list = []  # (unit_prefix, [shapes...])
        for k, s in entries:
            parts = k.split(".")
            pref = ".".join(parts[: min(d, len(parts) - 1)])
            if groups and groups[-1][0] == pref:
                groups[-1][1].append(s)
            else:
                groups.append((pref, [s]))
        by_sig: dict = {}
        for pref, sig in groups:
            by_sig.setdefault(tuple(sig), []).append(pref)
        for prefs in by_sig.values():
            distinct = sorted(set(prefs))
            for a, b in zip(distinct, distinct[1:]):
                pairs.add((a, b))
    return sorted(pairs)


def propose_name_map(state_dict: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Propose a foreign-key -> twin-key mapping for any `.pth` state_dict
    by shape and order.

    Both state_dicts keep module registration order, which follows the
    network's data flow; after dropping 0-dim bookkeeping entries, a
    two-pointer walk matching exact tensor shapes aligns them. Returns
        {'mapping': {foreign: twin}, 'unmatched_foreign': [...],
         'unmatched_twin': [...], 'ambiguous': [(unitA, unitB), ...],
         'complete': bool}.
    `ambiguous` lists foreign module units with identical shape signatures,
    whose pairing shape matching cannot verify; `complete` is True only when
    every twin key matched and there is no such ambiguity."""
    expected = twin_key_order(cfg)
    foreign = []
    for k, v in state_dict.items():
        shape = tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)
        if len(shape) == 0:  # num_batches_tracked and friends
            continue
        foreign.append((k, shape))

    mapping: Dict[str, str] = {}
    un_f, un_t = [], []
    i = j = 0
    while i < len(foreign) and j < len(expected):
        fk, fs = foreign[i]
        tk, ts = expected[j]
        if fs == ts:
            mapping[fk] = tk
            i += 1
            j += 1
            continue
        # skip one side: an extra foreign tensor, or a missing one
        if i + 1 < len(foreign) and foreign[i + 1][1] == ts:
            un_f.append(fk)
            i += 1
        else:
            un_t.append(tk)
            j += 1
    un_f += [k for k, _ in foreign[i:]]
    un_t += [k for k, _ in expected[j:]]
    ambiguous = _ambiguous_unit_pairs([(k, s) for k, s in foreign if k in mapping])
    return {
        "mapping": mapping,
        "unmatched_foreign": un_f,
        "unmatched_twin": un_t,
        "ambiguous": ambiguous,
        "complete": not un_t and not ambiguous,
    }


def variables_from_foreign_state(
    state_dict: Mapping[str, Any],
    cfg: ModelConfig,
    name_map=None,
    allow_ambiguous: bool = False,
) -> Dict[str, Any]:
    """Port a foreign (not twin-named) torch state_dict.

    With `name_map` ((regex, replacement) rules) the keys are rewritten to
    the twin contract; without it `propose_name_map` aligns by shape and
    order and raises ValueError with a report when the alignment is
    incomplete or order-ambiguous. `allow_ambiguous=True` accepts an
    alignment whose only defect is identical-signature units: use it only
    after checking that the foreign net registers its modules in data-flow
    order."""
    if name_map is not None:
        return variables_from_torch_state(apply_name_map(state_dict, name_map), cfg)
    prop = propose_name_map(state_dict, cfg)
    if prop["unmatched_twin"]:
        raise ValueError(
            "shape/order auto-mapping incomplete:\n"
            f"  unmatched twin keys:    {prop['unmatched_twin'][:10]}\n"
            f"  unmatched foreign keys: {prop['unmatched_foreign'][:10]}\n"
            "Provide an explicit name_map=[(regex, replacement), ...]."
        )
    if prop["ambiguous"] and not allow_ambiguous:
        raise ValueError(
            "shape/order auto-mapping is order-AMBIGUOUS: these adjacent "
            "units have identical shape signatures, so a swapped "
            "registration order would port crosswise undetected:\n  "
            + "\n  ".join(f"{a} <-> {b}" for a, b in prop["ambiguous"][:10])
            + "\nVerify the foreign net's registration order follows its "
            "data flow, then pass allow_ambiguous=True (or provide an "
            "explicit name_map)."
        )
    renamed = {prop["mapping"][k]: v for k, v in state_dict.items() if k in prop["mapping"]}
    return variables_from_torch_state(renamed, cfg)


def unwrap_checkpoint(ckpt):
    """A bare state_dict, or the dict under a 'state_dict', 'model' or
    'model_state_dict' entry of a checkpoint container."""
    if isinstance(ckpt, dict):
        for key in ("state_dict", "model", "model_state_dict"):
            if key in ckpt and isinstance(ckpt[key], dict):
                return ckpt[key]
    return ckpt


def read_checkpoint(path: str):
    """The unwrapped state_dict of a `.pth` file, read on the CPU."""
    return unwrap_checkpoint(torch.load(path, map_location="cpu", weights_only=False))


def load_torch_pth(
    path: str,
    cfg: ModelConfig,
    name_map=None,
    auto_map: bool = False,
    allow_ambiguous: bool = False,
) -> Dict[str, Any]:
    """Load a `.pth` checkpoint file and port it. Checkpoints named after
    another contract port through `name_map` or `auto_map=True` (shape and
    order alignment, `propose_name_map`)."""
    ckpt = read_checkpoint(path)
    if name_map is not None or auto_map:
        return variables_from_foreign_state(ckpt, cfg, name_map=name_map, allow_ambiguous=allow_ambiguous)
    return variables_from_torch_state(ckpt, cfg)
