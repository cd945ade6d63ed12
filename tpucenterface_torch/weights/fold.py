"""BatchNorm folding, head fusion and the stem bake, in numpy.

Mirrors `tpucenterface/weights/fold.py::fold_variables`, `fuse_head_params`,
`raw_pixel_offset`, `bake_preprocess_into_stem` and `s2d_remap_stem`. The
arithmetic is float64 numpy in the same order as the JAX version and is
rounded to float32 once at the end, so the folded tree is bit-identical to
the JAX package's. Trees stay
in the JAX layout (flax key names, HWIO kernels); `weights.convert` carries
them into the port's modules.

y = BN(conv(x)) with inference statistics is an affine map per output channel:
    scale = gamma / sqrt(var + eps)
    y = conv(x) * scale + (beta - mean * scale)

`s2d_remap_stem` (JAX `:106-125`) rewrites the 3x3/stride-2 stem as the
2x2/stride-1 stem of the space-to-depth model; `fold_variables(s2d_stem=True)`
applies it after the stem bake, as the JAX version does.
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


def s2d_remap_stem(kernel: np.ndarray) -> np.ndarray:
    """A 3x3/stride-2 stem kernel (3, 3, C, O) as the equivalent 2x2/stride-1
    kernel (2, 2, 4C, O) on the 2x space-to-depth input.

    The stem (pad 1, stride 2) computes
        out[i,j] = sum_{ky,kx} W[ky,kx] * x[2i+ky-1, 2j+kx-1];
    with x_s2d[r,s,(dy,dx,c)] = x[2r+dy, 2s+dx, c] each tap lands on
        ky=0 -> (u=0, dy=1), ky=1 -> (u=1, dy=0), ky=2 -> (u=1, dy=1)
    of a 2x2 conv with pad ((1,0),(1,0)); the (u=0, dy=0) slot is zero.
    """
    kh, kw, c, o = np.shape(kernel)
    if (kh, kw) != (3, 3):
        raise ValueError(f"s2d stem remap expects a 3x3 kernel, got {np.shape(kernel)}")
    kernel = np.asarray(kernel)
    out = np.zeros((2, 2, 4 * c, o), kernel.dtype)
    for ky in range(3):
        uy, dy = (0, 1) if ky == 0 else (1, ky - 1)
        for kx in range(3):
            ux, dx = (0, 1) if kx == 0 else (1, kx - 1)
            out[uy, ux, (dy * 2 + dx) * c : (dy * 2 + dx + 1) * c] = kernel[ky, kx]
    return out


def fold_variables(
    variables: Dict[str, Any],
    bn_eps: float = 1e-5,
    fuse_heads: bool = False,
    s2d_stem: bool = False,
    bake_preprocess=None,
) -> Dict[str, Any]:
    """Fold every {conv, bn} sibling pair into a biased conv; drop batch_stats.

    Returns {'params': folded_tree} for a ModelConfig(folded=True) model.
    Head scopes pass through, or are merged into one 'fused' scope with
    fuse_heads=True; bake_preprocess (a PreprocessConfig) bakes the input
    normalize into the stem; s2d_stem remaps the stem for the space-to-depth
    model, after the bake (which needs the 3-channel stem).
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
    if s2d_stem:
        stem = out["backbone"]["stem"]
        stem["conv"] = {
            "kernel": np.asarray(s2d_remap_stem(stem["conv"]["kernel"]), np.float32),
            "bias": stem["conv"]["bias"],
        }
    return {"params": out}
