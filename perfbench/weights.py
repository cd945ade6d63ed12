"""Random weights from the seed, made on the device in two large draws.

The variables are the raw ones a trained checkpoint holds (JAX layout:
HWIO kernels; BatchNorm scale, bias, running mean and variance, unfolded),
for every leaf that the architecture's `leaf_shapes` lists
(`reference/<arch>.py`), drawn by its kind:
- conv kernels normal with variance 1.125 / fan_in. With He's 2 / fan_in
  the random network is chaotic: it amplified a perturbation of its input
  twentyfold by the last block, and bfloat16 rounding alone moved the
  heatmap by a fifth of its spread, where a trained network moves by a
  few hundredths; at 1.125 a perturbation shrinks through the network;
- BatchNorm scale uniform in [0.8, 1.2], bias normal (std 0.1), running
  mean normal (std 0.1), running variance uniform in [0.6, 1.4];
- head conv biases and plain conv biases (kind `bias`, such as a squeeze
  and excitation gate's) normal (std 0.1), the heads' 1x1 out kernels He's;
- then each head's out conv scaled and shifted, channel by channel, so that
  on two painted 256 x 256 frames from the seed its map has the mean and
  spread a trained detector's has (`HEAD_TARGETS`): heatmap logits at the
  prior with a spread of 0.8, box sides 16 +- 2 pixels (on CenterFace's
  log scale where the configuration states `wh_log`), centre offsets
  0.5 +- 0.1 of a cell, landmarks within half a cell of the centre. Drawn
  alone, the heatmap's level swung from seed to seed by several logits: some
  seeds gave no score above a threshold, others scores of 1. So every seed
  gives a detector that finds about as much, and every cell of a map
  describes its own box, so that a detection can be told by where it lies.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench import registry

_UNIFORM = {"bn_scale": (0.8, 1.2), "bn_var": (0.6, 1.4)}
_NORMAL_01 = {"bn_bias", "bn_mean", "head_bias", "bias"}
_GAIN = 1.125
# head -> (mean, spread) of its map, in the map's units (cells for wh, off, lm)
HEAD_TARGETS = {"hm": (None, 0.8), "wh": (4.0, 0.5), "off": (0.5, 0.1), "lm": (0.0, 0.45)}
# the same box sides where the wh map holds their logarithms
WH_LOG_TARGET = (float(np.log(4.0)), 0.125)


def make_variables(cfg: dict, seed: int, device) -> Dict[str, dict]:
    """{"params": ..., "batch_stats": ...} of float32 numpy arrays."""
    leaves = registry.reference(cfg).leaf_shapes(cfg)
    sizes = [int(np.prod(shape)) for _, shape, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    uniform = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    scale = np.empty(sum(sizes), np.float32)
    shift = np.zeros(sum(sizes), np.float32)
    use_uniform = np.zeros(sum(sizes), bool)
    o = 0
    for (path, shape, kind), n in zip(leaves, sizes):
        he = (2.0 / float(np.prod(shape[:3]))) ** 0.5
        if kind == "kernel":
            scale[o:o + n] = (_GAIN / float(np.prod(shape[:3]))) ** 0.5
        elif kind.startswith("out_kernel_"):
            scale[o:o + n] = he
        elif kind.startswith("out_bias_"):
            scale[o:o + n] = 0.0
        elif kind in _UNIFORM:
            lo, hi = _UNIFORM[kind]
            scale[o:o + n], shift[o:o + n] = hi - lo, lo
            use_uniform[o:o + n] = True
        elif kind in _NORMAL_01:
            scale[o:o + n] = 0.1
        else:
            raise ValueError(f"no draw for the leaf kind {kind!r} of {'/'.join(path)}")
        o += n
    scale, shift, use_uniform = (torch.from_numpy(a).to(device) for a in (scale, shift, use_uniform))
    flat = (torch.where(use_uniform, uniform, normal) * scale + shift).cpu().numpy()
    out: Dict[str, dict] = {}
    o = 0
    for (path, shape, _), n in zip(leaves, sizes):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[o:o + n].reshape(shape)
        o += n
    _fit_heads(cfg, out, gen)
    return out


def _fit_heads(cfg: dict, variables: dict, gen: torch.Generator) -> None:
    """Scale and shift each head's out conv in place so that its map meets
    HEAD_TARGETS (the heatmap's mean: the configuration's prior) on two
    painted frames."""
    from perfbench import frames
    from perfbench.reference.detect import letterbox, normalise
    from perfbench.reference.model import float32_exact, to_device

    dev = gen.device
    imgs = frames.paint([(256, 256)] * 2, [4, 4], gen)
    x = torch.stack([letterbox(torch.from_numpy(f).to(dev), 256)[0] for f in imgs])
    pp = cfg["preprocess"]
    with torch.no_grad(), float32_exact():
        maps = registry.reference(cfg).Network(cfg, to_device(variables, dev))(normalise(x, pp["mean"], pp["std"]))
    for name, y in maps.items():
        mean, spread = WH_LOG_TARGET if name == "wh" and cfg["wh_log"] else HEAD_TARGETS[name]
        mean = float(cfg["hm_bias_init"]) if mean is None else mean
        m = y.reshape(-1, y.shape[-1]).double().mean(0).cpu().numpy()
        sd = y.reshape(-1, y.shape[-1]).double().std(0).cpu().numpy()
        a = spread / np.maximum(sd, 1e-12)
        out = variables["params"]["heads"][name]["out"]
        out["kernel"] = (out["kernel"] * a).astype(np.float32)
        out["bias"] = (a * (out["bias"] - m) + mean).astype(np.float32)
