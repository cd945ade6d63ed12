"""AdaRound: learned per-weight rounding for the W8A8 (or W4A8) forward.

Mirrors `tpucenterface/quant/adaround.py` (`_h`, `_h_init`, `_kernel_paths`,
`adaround`; Nagel et al. 2020, "Up or Down? Adaptive Rounding for
Post-Training Quantization"). Per quantized conv, front to back:

    W_q = s * clip(floor(W/s) + h(V), -qmax, qmax)
    h(V) = clip(sigmoid(V) * (zeta - gamma) + gamma, 0, 1),  zeta, gamma = 1.1, -0.1

minimizing ||act(conv(x_hat, W_q) + b) - y_float||^2 + lam * mean(1 - |2h-1|^beta)
with beta annealed from 20 to 2, where x_hat is the quantized net's
dequantized input to the conv (re-captured per layer, so upstream rounding is
compensated downstream) and y_float the float net's post-activation output.
The final mask is h >= 0.5, kept only where it reconstructs at least as well
as nearest rounding. The result is written back on-grid into `engine.p` with
the scale frozen in `engine.weight_scales[tag]`, so the serving forward's
round(k / s) reconstructs it exactly and the persisted pair (scales with
their "w:<tag>" entries, `quant_variables`) carries it. An end-to-end guard
reverts everything when the real-path head-map loss got worse.

The captures run the engine's per-conv route (`_cap_tag` names one conv a
forward; the JAX function captures every conv in one jitted forward, which
eager code does not need). A layer's captures span the whole calibration set
and are freed before the next layer's. Adam is `train.step.Optimizer(lr)`;
the steps of a layer leave everything on the device, and the losses are read
once a layer, as in the JAX function. clip, sigmoid's rectification and the
activations give JAX's gradient at ties (split evenly).
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from tpucenterface_torch.quant.engine import QuantEngine, clip_ties, conv_nhwc, quantize_weight_t, relu_ties
from tpucenterface_torch.quant.qat import _bias_paths, _tree_get, _tree_set, calibration_batches, head_map_loss
from tpucenterface_torch.train.step import Optimizer

_ZETA, _GAMMA = 1.1, -0.1


def _h(v: torch.Tensor) -> torch.Tensor:
    """Rectified sigmoid: the smooth [0, 1] rounding variable."""
    return clip_ties(torch.sigmoid(v) * (_ZETA - _GAMMA) + _GAMMA, 0.0, 1.0)


def _h_init(frac: torch.Tensor) -> torch.Tensor:
    """V such that h(V) == frac (the nearest-rounding fractional part): the
    optimization starts at round-to-nearest."""
    p = torch.clamp((frac - _GAMMA) / (_ZETA - _GAMMA), 1e-4, 1 - 1e-4)
    return torch.log(p / (1.0 - p))


def _kernel_paths(engine: QuantEngine) -> Dict[str, Tuple[str, ...]]:
    return {tag: path[:-1] + ("kernel",) for tag, path in _bias_paths(engine).items()}


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu6":
        return clip_ties(y, 0.0, 6.0)
    if act == "relu":
        return relu_ties(y)
    return y


def ada_step(tx: Optimizer, v, opt_state, beta: float, x_hat, y_t, floor, sw, b, stride: int, groups: int,
             act: str, qmax: float, reg_weight: float):
    """One Adam step on the rounding variables `v` of one layer
    (`adaround.py:222-243` of the JAX package): (new v, new opt_state, the
    reconstruction MSE on the device)."""
    vv = v.detach().requires_grad_()
    with torch.enable_grad():
        kq = sw * clip_ties(floor + _h(vv), -qmax, qmax)
        y = _act(conv_nhwc(x_hat, kq, stride, groups) + b, act)
        mse = torch.mean((y - y_t) ** 2)
        reg = torch.mean(1.0 - torch.abs(2.0 * _h(vv) - 1.0) ** beta)
        (grad,) = torch.autograd.grad(mse + reg_weight * reg, vv)
    updates, opt_state = tx.update({"v": grad}, opt_state, {"v": v})
    return v + updates["v"], opt_state, mse.detach()


def _hard_mse(kk, x_hat, y_t, b, stride, groups, act) -> torch.Tensor:
    with torch.no_grad():
        y = _act(conv_nhwc(x_hat, kk.float(), stride, groups) + b, act)
        return torch.mean((y - y_t) ** 2)


def adaround(
    engine: QuantEngine,
    batches: List[Any],
    steps: int = 250,
    lr: float = 1e-2,
    reg_weight: float = 0.01,
    beta_range: Tuple[float, float] = (20.0, 2.0),
) -> Dict[str, float]:
    """Learn per-weight rounding for every quantized conv of a calibrated
    engine on `batches` (normalized NHWC arrays or tensors, one spatial
    size). Rewrites `engine.p`'s kernels on-grid and fills
    `engine.weight_scales`; returns {tag: learned / nearest hard-rounding
    reconstruction MSE} (each <= 1) and `_e2e_first`, `_e2e_last` (the
    real-path head-map loss against the float model before and after) and
    `_accepted` (0.0: the end-to-end guard reverted everything)."""
    if engine.act_scales is None:
        raise ValueError("adaround requires a calibrated engine")
    if not batches:
        raise ValueError("adaround needs at least one batch")
    shapes = {tuple(np.shape(b)[1:]) for b in batches}
    if len(shapes) != 1:
        raise ValueError(
            f"adaround needs all calibration batches at one spatial size (got {sorted(shapes)}); resize or split "
            f"the calibration set"
        )
    qmax = float(engine.wqmax)
    dev = engine.device
    xs = calibration_batches(engine, batches)
    kpaths = _kernel_paths(engine)
    bpaths = _bias_paths(engine)
    float_p = engine.p  # the float reference, never changed
    work_p = engine.p  # takes each layer's on-grid kernel as it finishes
    keys = ["hm", "whoff"] + (["lm"] if engine.cfg.with_landmarks else [])

    # each pending layer's weight scale derived from its float kernel with
    # `quantize_weight_t`'s rule, a finished layer's frozen one: installed for
    # every quant forward below, so the captures and the end-to-end loss
    # quantize as the served program will
    ws = {tag: quantize_weight_t(_tree_get(work_p, kp), None, engine.wqmax)[1]
          for tag, kp in kpaths.items() if engine.quantizes(tag)}

    def capture(mode, p, tag, x, w=None):
        engine._cap_tag, engine._cap_out = tag, {}
        try:
            with torch.no_grad():
                engine._forward(x, mode, params=p, weight_scales=w)
            return engine._cap_out
        finally:
            engine._cap_tag, engine._cap_out = None, {}

    with torch.no_grad():
        fheads = []
        for x in xs:
            out = engine._forward(x, "float", params=float_p)
            fheads.append({k: out[k].float() for k in keys})

    def e2e_loss(p) -> float:
        with torch.no_grad():
            tot = torch.zeros((), dtype=torch.float32, device=dev)
            for x, t in zip(xs, fheads):
                tot = tot + head_map_loss(engine._forward(x, "quant", params=p, weight_scales=ws), t, keys)
            return float(tot / len(xs))

    e2e_first = e2e_loss(work_p)
    tx = Optimizer(lr=lr)
    report: Dict[str, float] = {}
    for tag in kpaths:
        if not engine.quantizes(tag):
            continue
        x_hat, meta = [], None
        for x in xs:
            c = capture("quant", work_p, tag, x, ws)
            if "xq" not in c:
                x_hat = None
                break  # the conv never runs quantized in this graph
            x_hat.append(c["xq"].float() * c["sx"])
            meta = c
            del c
        if x_hat is None:
            continue
        stride, groups, act = meta["stride"], meta["groups"], meta["act"]
        x_hat = torch.cat(x_hat)
        y_t = torch.cat([capture("float", float_p, tag, x)["y"] for x in xs])

        k = _tree_get(work_p, kpaths[tag]).float()
        b = _tree_get(work_p, bpaths[tag]).float()
        sw = ws[tag]
        kdiv = k / sw
        floor = torch.floor(kdiv)
        v = _h_init(kdiv - floor)
        opt_state = tx.init({"v": v})
        for i in range(int(steps)):
            t = i / max(1, int(steps) - 1)
            beta = beta_range[0] + (beta_range[1] - beta_range[0]) * t
            v, opt_state, _ = ada_step(tx, v, opt_state, float(np.float32(beta)), x_hat, y_t, floor, sw, b,
                                       stride, groups, act, qmax, reg_weight)

        # the final hard rounding, kept only where it beats nearest rounding
        # on the same reconstruction
        dtype = _tree_get(work_p, kpaths[tag]).dtype
        mask = (_h(v) >= 0.5).float()
        k_new = (sw * torch.clamp(floor + mask, -qmax, qmax)).to(dtype)
        k_nearest = sw * torch.clamp(torch.round(kdiv), -qmax, qmax)
        m_new = float(_hard_mse(k_new, x_hat, y_t, b, stride, groups, act))
        m_near = float(_hard_mse(k_nearest, x_hat, y_t, b, stride, groups, act))
        if m_new <= m_near:
            work_p = _tree_set(work_p, kpaths[tag], k_new)
            report[tag] = m_new / max(m_near, 1e-12)
        else:
            work_p = _tree_set(work_p, kpaths[tag], k_nearest.to(dtype))
            report[tag] = 1.0
        engine.weight_scales[tag] = sw.cpu().numpy()
        del x_hat, y_t, v, opt_state

    # the end-to-end guard: ship the learned rounding only if the real-path
    # loss did not get worse, else restore the untouched engine
    engine.p = work_p
    e2e_last = e2e_loss(work_p)
    accepted = e2e_last <= e2e_first
    if not accepted:
        engine.weight_scales.clear()
        engine.p = float_p
    report["_e2e_first"] = e2e_first
    report["_e2e_last"] = e2e_last if accepted else e2e_first
    report["_accepted"] = float(accepted)
    return report
