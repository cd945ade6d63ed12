"""The program's own spans in a traced window, and what the device did
under them.

The port names the layer boundaries of its entry points `tcf.<layer>`
(`tcf.stage`, `tcf.preprocess`, `tcf.forward`, `tcf.decode`, `tcf.results`,
`tcf.build`; the TTA runner's `tcf.tta.pad`, `tcf.tta.assemble`,
`tcf.tta.merge`): torch.profiler ranges on the thread that drives the
window, which `trace.read_trace` keeps in `Trace.host` beside the operators.
The kernel wrappers' work ranges, `tcf::<kernel> ...`, are not spans. Over
the spans of the given names, clipped to the window:

- `launched_s`: device seconds of the events whose launch on the host (by
  correlation id, `Trace.launched`) fell inside such a span, wherever on
  the device they ran;
- `idle_s`: seconds of the window with nothing on the device (the
  complement of `Trace.busy_intervals`) that fall inside such a span.

Both give None where the window holds no span of those names, so that a
renamed or missing span reads as nothing, never as 0. The per-image forms
are what the readers in `metrics/` return.

`python3 -m perfbench.spans --workload <cell> --seed <n>` makes one traced
run of a cell on the card and prints, as one JSON line, each span's count,
host, launched and idle seconds, the idle that no span covers (and the
longest such stretches, named by the host event at their middle), the
window's ten longest idle gaps as the result line names them, the checks
of the shared clock (`launch_lead_us`, `results_overrun_us`) and,
with `--span-cost`, the host cost of one `annotate` span with no profiler
and under one (the one place of the benchmark, beside `program.py` and the
entries, that imports the program).
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from perfbench.trace import Trace

PREFIX = "tcf."
WORK_PREFIX = "tcf::"

Interval = Tuple[float, float]
Names = Union[str, Iterable[str]]


def is_span(name: str) -> bool:
    return name.startswith(PREFIX) and not name.startswith(WORK_PREFIX)


def _names(names: Names) -> set:
    return {names} if isinstance(names, str) else set(names)


def spans(tr: Trace, names: Names) -> List[Interval]:
    """The window's spans of `names`, clipped to it, in order of start
    (microseconds)."""
    want = _names(names)
    return sorted((max(h.start, tr.start), min(h.end, tr.end)) for h in tr.host
                  if h.name in want and h.end > tr.start and h.start < tr.end)


def union(ivs: Sequence[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def idle_intervals(tr: Trace) -> List[Interval]:
    """The stretches of the window with no kernel, copy or memset."""
    edges = [tr.start] + [t for iv in tr.busy_intervals() for t in iv] + [tr.end]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]]


def overlap_s(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Seconds common to two lists of disjoint intervals in order."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        tot += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot / 1e6


def subtract(a: Sequence[Interval], b: Sequence[Interval]) -> List[Interval]:
    """The parts of `a` outside `b`, both disjoint intervals in order."""
    out: List[Interval] = []
    j = 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def launched_in(tr: Trace, names: Names) -> Optional[List[tuple]]:
    """(device event, its launch time, the span it was launched in) for each
    device event launched inside a span of `names`; None without such a
    span."""
    ivs = union(spans(tr, names))
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    out = []
    for e in tr.device:
        t = tr.launched.get(e.corr)
        k = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if k >= 0 and t <= ivs[k][1]:
            out.append((e, t, ivs[k]))
    return out


def launched_s(tr: Trace, names: Names) -> Optional[float]:
    found = launched_in(tr, names)
    return None if found is None else sum(e.end - e.start for e, _, _ in found) / 1e6


def idle_s(tr: Trace, names: Names) -> Optional[float]:
    ivs = union(spans(tr, names))
    return overlap_s(ivs, idle_intervals(tr)) if ivs else None


def _ms_per_image(ctx, seconds_of, names: Names) -> Optional[float]:
    if ctx.trace is None or not ctx.images:
        return None
    s = seconds_of(ctx.trace, names)
    return None if s is None else s * 1e3 / ctx.images


def launched_ms_per_image(ctx, names: Names) -> Optional[float]:
    """`launched_s` of the traced window in milliseconds per image."""
    return _ms_per_image(ctx, launched_s, names)


def idle_ms_per_image(ctx, names: Names) -> Optional[float]:
    """`idle_s` of the traced window in milliseconds per image."""
    return _ms_per_image(ctx, idle_s, names)


def span_names(tr: Trace) -> List[str]:
    """The names of the program's spans in the window, each once."""
    return sorted({h.name for h in tr.host if is_span(h.name) and h.end > tr.start and h.start < tr.end})


def launch_lead_us(tr: Trace, names: Optional[Names] = None) -> Optional[float]:
    """The most by which a device event launched inside a span (of `names`;
    of every name by default) starts before its launch on the host: above a
    few microseconds the host's and the device's clocks disagree, and the
    attribution cannot hold."""
    found = launched_in(tr, span_names(tr) if names is None else names)
    return max((t - e.start for e, t, _ in found), default=None) if found else None


def _host_name(tr: Trace, t: float) -> str:
    """The innermost host event running at `t`, or, where none runs, the
    host events that end before it and start after it."""
    inner = min((h for h in tr.host if h.start <= t <= h.end), key=lambda h: h.end - h.start, default=None)
    if inner is not None:
        return inner.name[:120]
    before = max((h for h in tr.host if h.end < t), key=lambda h: h.end, default=None)
    after = min((h for h in tr.host if h.start > t), key=lambda h: h.start, default=None)
    return f"after {before.name[:60] if before else '-'}; before {after.name[:60] if after else '-'}"


def results_overrun_us(tr: Trace) -> Optional[float]:
    """The most by which a device event launched inside a `tcf.results` span
    ends after that span ends: the fetch waits for its copies, so this is
    never above 0 on a shared clock."""
    found = launched_in(tr, "tcf.results")
    return max((e.end - iv[1] for e, _, iv in found), default=None) if found else None


def unspanned_idle(tr: Trace, n: int = 10) -> Tuple[float, List[list]]:
    """Seconds of the window's idle time inside no span, and its `n` longest
    stretches (seconds, and their start in the window), each named by the
    host events at its middle (`_host_name`)."""
    bare = subtract(idle_intervals(tr), union(spans(tr, span_names(tr))))
    total = sum(e - s for s, e in bare) / 1e6
    bare.sort(key=lambda iv: iv[0] - iv[1])
    named = []
    for s, e in bare[:n]:
        named.append([_host_name(tr, (s + e) / 2), (e - s) / 1e6, (s - tr.start) / 1e6])
    return total, named


def summary(tr: Trace) -> Dict[str, object]:
    """Per span name its count, host, launched and idle seconds; the
    window's idle, the share of it inside no span, and the clock checks."""
    idle_total = sum(e - s for s, e in idle_intervals(tr)) / 1e6
    per = {}
    for name in span_names(tr):
        ivs = spans(tr, name)
        per[name] = {"count": len(ivs), "host_s": sum(e - s for s, e in ivs) / 1e6,
                     "launched_s": launched_s(tr, name), "idle_s": idle_s(tr, name),
                     "lead_us": launch_lead_us(tr, name)}
    bare_s, longest = unspanned_idle(tr)
    return {"window_s": tr.window_s, "busy_s": tr.busy_s(), "idle_s": idle_total, "spans": per,
            "unspanned_idle_s": bare_s, "unspanned_idle_share": bare_s / idle_total if idle_total else None,
            "unspanned_idle_longest": longest, "launch_lead_us": launch_lead_us(tr),
            "results_overrun_us": results_overrun_us(tr)}


def span_cost_us(n: int = 20000, reps: int = 3) -> Dict[str, float]:
    """Host microseconds of one `annotate` span, entered and left, with no
    profiler running and under torch.profiler (CPU and CUDA activities),
    each the best of `reps` loops of `n`."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpucenterface_torch.runtime.profiling import annotate

    def loop() -> float:
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(n):
                with annotate("tcf.cost"):
                    pass
            best = min(best, time.perf_counter() - t0)
        return best / n * 1e6

    off = loop()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts):
        on = loop()
    return {"off_us": off, "on_us": on, "n": n}


def report(workload: str, seed: int, device, root=None, cost: bool = False) -> Dict[str, object]:
    """One traced run of a cell (`run.run`, as `--trace 1` makes it) and
    what its spans show: the object `main` prints."""
    from perfbench import registry, run

    root = registry.ROOT if root is None else root
    result = run.run(workload, seed, 0.0, True, device, root=root)
    tr = result["trace"]
    out = {"workload": workload, "seed": seed, "correct": result["correct"],
           "calls": result["attempted"] / registry.cell(workload, root).traffic["images_per_call"],
           "metrics": {k: v["value"] for k, v in result["metrics"].items()}, **summary(tr),
           "idle_gaps": tr.idle_gaps()}
    if cost:
        out["span_cost"] = span_cost_us()
    return out


def main(argv=None) -> int:
    import argparse
    import json
    import sys

    import torch

    from perfbench import run

    p = argparse.ArgumentParser(description="one traced run of a cell, its spans summed (see module doc)")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--span-cost", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench.spans: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = report(args.workload, args.seed, device, cost=args.span_cost)
    print(json.dumps(dict(out, card=run.card(device))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
