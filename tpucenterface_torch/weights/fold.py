"""BatchNorm folding, head fusion and the stem bake, in numpy.

Mirrors `tpucenterface/weights/fold.py::fold_variables`, `fuse_head_params`,
`raw_pixel_offset` and `bake_preprocess_into_stem`. The arithmetic is float64
numpy in the same order as the JAX version and is rounded to float32 once at
the end, so the folded tree is bit-identical to the JAX package's. Trees stay
in the JAX layout (flax key names, HWIO kernels); `weights.convert` carries
them into the port's modules.

y = BN(conv(x)) with inference statistics is an affine map per output channel:
    scale = gamma / sqrt(var + eps)
    y = conv(x) * scale + (beta - mean * scale)

The space-to-depth stem remap (`s2d_remap_stem`) is not ported: the port's
model has no s2d stem yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def fuse_head_params(heads: Dict[str, Any], names) -> Dict[str, Any]:
    """Merge per-branch head params into one wide 3x3 conv + a block-diagonal
    1x1 out conv (mathematically identical to the separate branches)."""
    ks = [np.asarray(heads[n]["conv"]["kernel"]) for n in names]
    bs = [np.asarray(heads[n]["conv"]["bias"]) for n in names]
    ows = [np.asarray(heads[n]["out"]["kernel"]) for n in names]
    obs = [np.asarray(heads[n]["out"]["bias"]) for n in names]
    hidden = [k.shape[-1] for k in ks]
    outs = [w.shape[-1] for w in ows]
    kcat = np.concatenate(ks, axis=-1)                    # (3,3,C, sum_hidden)
    bcat = np.concatenate(bs, axis=-1)
    wblk = np.zeros((1, 1, sum(hidden), sum(outs)), kcat.dtype)
    ho = co = 0
    for h, o, w in zip(hidden, outs, ows):
        wblk[0, 0, ho : ho + h, co : co + o] = w[0, 0]
        ho += h
        co += o
    oblk = np.concatenate(obs, axis=-1)
    return {
        "conv": {"kernel": kcat, "bias": bcat},
        "out": {"kernel": wblk, "bias": oblk},
    }


def raw_pixel_offset(pp_cfg) -> np.ndarray:
    """Per-channel raw-pixel offset of the stem_preprocess convention, in
    INPUT channel order: 255*mean, reversed for BGR inputs (float64)."""
    mean = np.asarray(pp_cfg.mean, np.float64) * 255.0
    if pp_cfg.bgr_input:
        mean = mean[::-1]
    return mean


def bake_preprocess_into_stem(stem_conv: Dict[str, Any], pp_cfg) -> Dict[str, Any]:
    """Compose the input normalization (BGR->RGB flip, /255, mean/std) into
    the folded stem conv: A[..,c,o] = K[..,flip(c),o] / (255*std[c]), bias
    unchanged. The model is then fed `u - 255*mean`; the zero point is the
    mean pixel in both conventions, so the stem's zero padding means the same
    thing and the bake is exact including borders."""
    k = np.asarray(stem_conv["kernel"], np.float64)   # (kh, kw, 3, O)
    b = np.asarray(stem_conv["bias"])
    if k.shape[2] != 3:
        raise ValueError(f"stem bake expects a 3-input-channel stem, got {k.shape}")
    std = np.asarray(pp_cfg.std, np.float64) * 255.0   # RGB order
    a = k / std.reshape(1, 1, 3, 1)
    if pp_cfg.bgr_input:
        a = a[:, :, ::-1, :]
    return {
        "kernel": np.ascontiguousarray(a, dtype=np.float32),
        "bias": np.asarray(b, np.float32),
    }


def fold_variables(
    variables: Dict[str, Any],
    bn_eps: float = 1e-5,
    fuse_heads: bool = False,
    bake_preprocess=None,
) -> Dict[str, Any]:
    """Fold every {conv, bn} sibling pair into a biased conv; drop batch_stats.

    Returns {'params': folded_tree} for a ModelConfig(folded=True) model.
    Head scopes pass through, or are merged into one 'fused' scope with
    fuse_heads=True; bake_preprocess (a PreprocessConfig) bakes the input
    normalize into the stem.
    """
    params = variables["params"]
    stats = variables["batch_stats"]

    def rec(p_node, s_node):
        if isinstance(p_node, dict) and "conv" in p_node and "bn" in p_node:
            kernel = np.asarray(p_node["conv"]["kernel"], np.float64)
            gamma = np.asarray(p_node["bn"]["scale"], np.float64)
            beta = np.asarray(p_node["bn"]["bias"], np.float64)
            mean = np.asarray(s_node["bn"]["mean"], np.float64)
            var = np.asarray(s_node["bn"]["var"], np.float64)
            scale = gamma / np.sqrt(var + bn_eps)
            return {
                "conv": {
                    "kernel": np.asarray(kernel * scale, np.float32),
                    "bias": np.asarray(beta - mean * scale, np.float32),
                }
            }
        if isinstance(p_node, dict):
            return {
                k: rec(v, s_node.get(k, {}) if isinstance(s_node, dict) else {})
                for k, v in p_node.items()
            }
        return np.asarray(p_node)

    out = rec(params, stats)
    if fuse_heads:
        names = [n for n in ("hm", "wh", "off", "lm") if n in out["heads"]]
        out["heads"] = {"fused": fuse_head_params(out["heads"], names)}
    if bake_preprocess is not None:
        stem = out["backbone"]["stem"]
        stem["conv"] = bake_preprocess_into_stem(stem["conv"], bake_preprocess)
    return {"params": out}
