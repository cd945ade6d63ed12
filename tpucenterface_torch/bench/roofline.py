"""Whole-program MFU / HBM-roofline reduction of a per-op profile.

Mirrors `tpucenterface/bench/roofline.py` (`per_op_floor_ms`,
`section_table`, `summarize_rows`, `roofline_of_fn`, `SECTION_OF_CATEGORY`,
`RECORDED_SECTION_FLOORS`) with the same arithmetic and field names: the rows
of `bench.op_profile.op_profile_table` (one program iteration each) reduce to
achieved TFLOP/s and `mfu` against the peak of the compute dtype, achieved
TB/s and `hbm_frac` against the HBM rate, and a per-section table of times
beside their roofline floors, so that a regression moves a number and names
the section that broke.

The peaks are one NVIDIA H100 SXM's data-sheet rates (dense, no sparsity) at
its full 700 W: peaks that no kernel can beat keep every share at or below
1 (a measured peak could be). A card set to a lower power limit reaches less.
The JAX module's peaks were measured on its TPU and have other names.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

# NVIDIA H100 SXM data sheet, dense rates
PEAK_BF16_TFLOPS = 989.0   # bf16 tensor cores
PEAK_INT8_TOPS = 1979.0    # int8 tensor cores
PEAK_F32_TFLOPS = 67.0     # float32 outside the tensor cores: the rate of the non-matrix rows
PEAK_HBM_TBPS = 3.35       # HBM3

# op_profile category -> program section, JAX's sections: conv = the
# forward's convolutions and matrix products (cuDNN, the GEMMs of the int8
# library route, the port's MBConv and int8 block kernels); input = copies,
# memsets and layout transposes; decode = the decode kernels, sorts, top-K
# and gathers; neck = the upsample. The rest (elementwise passes, reductions,
# concatenations) is "other".
SECTION_OF_CATEGORY = {
    "convolution": "conv",
    "matmul": "conv",
    "conv": "conv",
    "copy": "input",
    "memset": "input",
    "data formatting": "input",
    "decode": "decode",
    "sort": "decode",
    "index": "decode",
    "upsample": "neck",
}
# tensor-core categories; every other category is costed at PEAK_F32_TFLOPS
_MXU_CATEGORIES = ("convolution", "matmul", "conv")


def per_op_floor_ms(row: dict, int8: bool = False) -> float:
    """Per-op speed-of-light time: max(compute axis, HBM axis). The compute
    axis takes the tensor-core peak of the dtype for the convolution and
    matrix categories and the float32 rate otherwise."""
    cat = row.get("category", "")
    if any(cat.startswith(m) for m in _MXU_CATEGORIES):
        peak_tflops = PEAK_INT8_TOPS if int8 else PEAK_BF16_TFLOPS
    else:
        peak_tflops = PEAK_F32_TFLOPS
    # GFLOP / (TFLOP/s) == ms; GB / (TB/s) == ms
    compute_ms = row.get("gflops_per_iter", 0.0) / peak_tflops
    hbm_ms = row.get("gbytes_per_iter", 0.0) / PEAK_HBM_TBPS
    return max(compute_ms, hbm_ms)


# Demonstrated per-section floors (ms), keyed by (mode, section), for the
# canonical serving program (bs128 @ 640, identity, K = 100). None has been
# shown on a card yet, so `recorded_floors=True` attaches nothing.
RECORDED_SECTION_FLOORS: Dict[tuple, float] = {}


def section_table(rows: Sequence[dict], int8: bool = False, recorded_floors: bool = False) -> Dict[str, dict]:
    """Per-section {ms, floor_ms, ratio[, recorded_floor_ms, vs_recorded]}:
    floor_ms sums `per_op_floor_ms` over the section's rows; the recorded
    floors attach only where asked (the canonical serving program) and
    where RECORDED_SECTION_FLOORS has one."""
    mode = "int8" if int8 else "bf16"
    secs: Dict[str, dict] = {}
    for r in rows:
        sec = SECTION_OF_CATEGORY.get(r.get("category", ""), "other")
        d = secs.setdefault(sec, {"ms": 0.0, "floor_ms": 0.0})
        d["ms"] += r.get("ms_per_iter", 0.0)
        d["floor_ms"] += per_op_floor_ms(r, int8=int8)
    for sec, d in secs.items():
        d["ms"] = round(d["ms"], 3)
        d["floor_ms"] = round(d["floor_ms"], 3)
        d["ratio"] = round(d["ms"] / d["floor_ms"], 2) if d["floor_ms"] > 0 else None
        rec = RECORDED_SECTION_FLOORS.get((mode, sec))
        if recorded_floors and rec is not None:
            d["recorded_floor_ms"] = rec
            d["vs_recorded"] = round(d["ms"] / rec, 3)
    return dict(sorted(secs.items(), key=lambda kv: -kv[1]["ms"]))


def summarize_rows(
    rows: Sequence[dict],
    int8: bool = False,
    peak_tflops: Optional[float] = None,
    peak_hbm_tbps: float = PEAK_HBM_TBPS,
) -> Dict[str, object]:
    """Reduce op_profile_table rows to whole-program roofline numbers:
    achieved TFLOP/s and `mfu` (against `peak_tflops`, by default the
    tensor-core peak of the compute dtype), achieved TB/s and `hbm_frac`."""
    total_ms = sum(r.get("ms_per_iter", 0.0) for r in rows)
    total_gflops = sum(r.get("gflops_per_iter", 0.0) for r in rows)
    total_gbytes = sum(r.get("gbytes_per_iter", 0.0) for r in rows)
    if peak_tflops is None:
        peak_tflops = PEAK_INT8_TOPS if int8 else PEAK_BF16_TFLOPS
    if total_ms <= 0:
        return {
            "total_ms": 0.0, "tflops": None, "mfu": None,
            "hbm_tbps": None, "hbm_frac": None,
            "gflops": total_gflops, "gbytes": total_gbytes,
        }
    # GFLOP / ms == TFLOP/s; GB / ms == TB/s
    tflops = total_gflops / total_ms
    hbm_tbps = total_gbytes / total_ms
    return {
        "total_ms": round(total_ms, 3),
        "gflops": round(total_gflops, 2),
        "gbytes": round(total_gbytes, 3),
        "tflops": round(tflops, 2),
        "mfu": round(tflops / peak_tflops, 4),
        "hbm_tbps": round(hbm_tbps, 4),
        "hbm_frac": round(hbm_tbps / peak_hbm_tbps, 4),
        "peak_tflops": peak_tflops,
        "peak_hbm_tbps": peak_hbm_tbps,
    }


def roofline_of_fn(
    fn, args, iters: int = 3, int8: bool = False,
    logdir: Optional[str] = None, recorded_floors: bool = False,
) -> Dict[str, object]:
    """Trace `fn(*args)` with torch.profiler on the device of its tensors
    (`bench.op_profile.capture_trace`) and reduce it to the whole-program
    summary and its sections. `recorded_floors=True` only for the canonical
    serving program (see `section_table`)."""
    import tempfile

    from tpucenterface_torch.bench.op_profile import capture_trace, op_profile_table

    logdir = logdir or tempfile.mkdtemp(prefix="tpucf_roofline_")
    paths = capture_trace(fn, args, logdir, iters=iters)
    rows = op_profile_table(paths, iters=iters)
    out = summarize_rows(rows, int8=int8)
    out["sections"] = section_table(rows, int8=int8, recorded_floors=recorded_floors)
    return out
