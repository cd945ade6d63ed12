"""Quantization-aware fine-tuning (QAT) of the W8A8 forward.

Mirrors `tpucenterface/quant/qat.py` (`_bias_paths`, `_tree_get`,
`_tree_set`, `_tree_add`, `head_map_loss`, `qat_finetune`). Two label-free
stages on the calibration frames, distilling the real int8 forward toward the
float forward's own head maps:

1. bias correction: the per-channel pre-activation mean gap between the float
   and the real int8 forward, absorbed into the conv biases over `bc_passes`
   passes (stopping at the first pass that does not lower the loss), then a
   final pass on `head.out` alone;
2. straight-through fine-tuning (`steps > 0`): Adam steps through the
   engine's differentiable 'fakequant' forward, weights fake-quantized with
   the serving rule, activations at the frozen calibrated scales.

Every candidate is selected on the loss of the real quant forward over the
whole calibration set, with the candidate cast to the engine's parameter
dtypes first, and the best one seen is installed into `engine.p` (which
re-installs the served int8 weights, and under `fused_blocks` the block
kernel's operands). So `loss_last <= loss_bc <= loss_first`.

Adam is `train.step.Optimizer(lr=lr)`: optax's `adam` with a constant rate.
The STE loop leaves the losses on the device; they are read where the JAX
function reads them: at selection, every `eval_every` steps and after each
bias-correction pass. The fake-quant loss is piecewise constant in most
weights, so two runs (two devices, or the two packages) part after a few
steps: compare one step, not whole runs.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from tpucenterface_torch.quant.engine import QuantEngine, _tree_get
from tpucenterface_torch.train.step import Optimizer, _unzip, tree_build, tree_map, tree_paths


def _bias_paths(engine: QuantEngine) -> Dict[str, Tuple[str, ...]]:
    """Each conv tag of the engine graph -> its bias' path in `engine.p`."""
    return {tag: node + ("bias",) for tag, node in engine.conv_paths().items()}


def _tree_set(params, path: Tuple[str, ...], value):
    """Functional nested-dict update: params[path] = value."""
    out = dict(params)
    if len(path) == 1:
        out[path[0]] = value
    else:
        out[path[0]] = _tree_set(params[path[0]], path[1:], value)
    return out


def _tree_add(params: Dict[str, Any], path: Tuple[str, ...], delta):
    """Functional nested-dict update: params[path] += delta."""
    return _tree_set(params, path, _tree_get(params, path) + delta)


def head_map_loss(out, target, keys) -> torch.Tensor:
    """Normalized per-head MSE between two head-map dicts: the metric QAT
    selects on and AdaRound's end-to-end guard uses (a float32 scalar)."""
    tot = target[keys[0]].new_zeros((), dtype=torch.float32)
    for k in keys:
        d = out[k].float() - target[k]
        tot = tot + torch.mean(d * d) / (torch.mean(target[k] * target[k]) + 1e-6)
    return tot


def calibration_batches(engine: QuantEngine, batches: List[Any]) -> List[torch.Tensor]:
    """The batches as tensors on the engine's device that autograd may save
    (a tensor made under `torch.inference_mode` is copied)."""
    out = []
    for b in batches:
        t = torch.as_tensor(b).to(engine.device)
        out.append(t.clone() if t.is_inference() else t)
    return out


def qat_finetune(
    engine: QuantEngine,
    batches: List[Any],
    steps: int = 100,
    lr: float = 1e-4,
    eval_every: int = 5,
    bc_passes: int = 2,
    teacher_params: Any = None,
) -> Dict[str, float]:
    """Bias-correct, then (optionally) STE-fine-tune `engine.p` so the real
    int8 forward matches the float forward on `batches` (normalized NHWC
    arrays or tensors, the calibration batches). The engine must be
    calibrated. teacher_params: the float model to distill toward (default
    `engine.p`; `Detector.quantize` passes the params from before AdaRound).

    Returns {loss_first, loss_bc, loss_last, steps}: the real-path loss at the
    PTQ point, after bias correction, and of the installed params."""
    if engine.act_scales is None:
        raise ValueError(
            "qat_finetune requires a calibrated engine (activation scales are frozen QAT constants) — "
            "run calibrate() first"
        )
    if not batches:
        raise ValueError("qat_finetune needs at least one batch")
    keys = ["hm", "whoff"] + (["lm"] if engine.cfg.with_landmarks else [])
    xs = calibration_batches(engine, batches)
    orig = engine.p
    if teacher_params is None:
        teacher_params = engine.p

    with torch.no_grad():
        ts = []
        for x in xs:
            out = engine._forward(x, "float", params=teacher_params)
            ts.append({k: out[k].float() for k in keys})

    orig_dtypes = {path: a.dtype for path, a in tree_paths(orig)}

    def _cast_like_orig(params):
        pairs = tree_paths(params)
        return tree_build([p for p, _ in pairs], [a.to(orig_dtypes[p]) for p, a in pairs])

    def full_loss(params) -> torch.Tensor:
        # the selection metric: the real int8 forward on the candidate, cast
        # to the dtypes it will be installed in
        params = _cast_like_orig(params)
        with torch.no_grad():
            tot = torch.zeros((), dtype=torch.float32, device=engine.device)
            for x, t in zip(xs, ts):
                tot = tot + head_map_loss(engine._forward(x, "quant", params=params), t, keys)
            return tot / len(xs)

    def collect_means(mode, params):
        out: Dict[str, torch.Tensor] = {}
        with torch.no_grad():
            for x in xs:
                engine._bc_collector = {}
                engine._forward(x, mode, params=params)
                col, engine._bc_collector = engine._bc_collector, None
                for tag, v in col.items():
                    out[tag] = out.get(tag, 0.0) + v / len(xs)
        return out

    params = tree_map(lambda a: a.float(), orig)
    first = float(full_loss(params))
    best_loss, best_params = first, params

    # stage 1: bias correction against the real int8 path, each candidate
    # built from the best params and kept only if the loss falls
    try:
        paths = _bias_paths(engine)
        mf = collect_means("float", teacher_params)
        for _ in range(max(0, int(bc_passes))):
            mq = collect_means("quant", _cast_like_orig(best_params))
            cand = best_params
            for tag, path in paths.items():
                if tag in mf and tag in mq:
                    cand = _tree_add(cand, path, mf[tag] - mq[tag])
            fl = float(full_loss(cand))
            if fl < best_loss:
                best_loss, best_params = fl, cand
            else:
                break
        mq = collect_means("quant", _cast_like_orig(best_params))
        cand = _tree_add(best_params, paths["head.out"], mf["head.out"] - mq["head.out"])
        fl = float(full_loss(cand))
        if fl < best_loss:
            best_loss, best_params = fl, cand
    finally:
        engine._bc_collector = None
    loss_bc = best_loss

    # stage 2: straight-through Adam steps, selected every eval_every steps
    if int(steps) > 0:
        tx = Optimizer(lr=lr)
        params = best_params
        opt_state = tx.init(params)
        eval_every = max(1, int(eval_every))
        for i in range(int(steps)):
            j = i % len(xs)
            params, opt_state, _ = ste_step(engine, tx, params, opt_state, xs[j], ts[j], keys)
            if (i + 1) % eval_every == 0 or i + 1 == int(steps):
                fl = float(full_loss(params))
                if fl < best_loss:
                    best_loss, best_params = fl, params

    engine.p = _cast_like_orig(best_params)
    return {"loss_first": first, "loss_bc": loss_bc, "loss_last": best_loss, "steps": int(steps)}


def ste_loss_and_grads(engine: QuantEngine, params, x, t, keys):
    """(loss, grads tree) of the distillation loss through the 'fakequant'
    forward at `params`, the loss left on the device."""
    paths, flat = _unzip(params)
    flat = [a.detach().requires_grad_() for a in flat]
    with torch.enable_grad():
        out = engine._forward(x, "fakequant", params=tree_build(paths, flat))
        loss = head_map_loss(out, t, keys)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), tree_build(paths, grads)


def ste_step(engine: QuantEngine, tx: Optimizer, params, opt_state, x, t, keys):
    """One STE Adam step (`qat.py:301-305` of the JAX package): (new params,
    new opt_state, the loss on the device)."""
    loss, grads = ste_loss_and_grads(engine, params, x, t, keys)
    updates, opt_state = tx.update(grads, opt_state, params)
    paths, p = _unzip(params)
    return tree_build(paths, torch._foreach_add(p, _unzip(updates)[1])), opt_state, loss
