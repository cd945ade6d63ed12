"""A clock64 profile of B6 (`csrc/int8_block.cu`) on one CUDA card: where a
block's warps spend their time, phase by phase, at the default model's four
stride-2 blocks at batch 32 and a 640 input, on the planner's plans:

    python3 -m tpucenterface_torch.kernels.profile_b6

It builds a copy of the kernel's source with a clock64 mark at each phase
boundary the source marks (`instrument`) into `build/profile_b6/`: in every
eighth block, lane 0 of each warp adds the cycles since its previous mark to
one of eight counters in device memory. It checks the marked kernel against
`fused_block_int8_plain` bit for bit and prints one JSON line a block: each
phase's share of the sampled warps' cycles (the prologue, which issues the
input tile's copies and works out the indices; the wait for a chunk's
operands; stage A, the expand; its barrier; stage B, the depthwise; its
barrier; stage C, the project; the epilogue) and the device milliseconds of
a launch with and without the marks. A share is of the time a warp spends
between two marks, so it includes the time the warp waits while other
warps issue.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from tpucenterface_torch.kernels import build
from tpucenterface_torch.kernels.sweep_b6 import BATCH, BLOCKS_640, _inputs, _ms_a_launch
from tpucenterface_torch.ops import int8_block as ib

PHASES = ("prologue", "wait", "stage_a", "barrier_a", "stage_b", "barrier_b", "stage_c", "epilogue")
SAMPLE = 8   # every SAMPLE-th block is profiled
OUT_DIR = build.BUILD_DIR.parent / "profile_b6"

# csrc/int8_block.cu marks where the counters start with `// PROFILE_START`
# and each phase boundary with `// PROFILE(phase)`: the phase whose cycles
# end there (chunk k's stage C is closed by the mark at the top of chunk
# k + 1, the last one's at the epilogue)
_START = "  // PROFILE_START"
_SETUP = (
    f"  const bool prof_on = blockIdx.x % {SAMPLE} == 0 && lane == 0;\n"
    "  long long prof_t = clock64();\n"
    "#define MARK(i) do { if (prof_on) { const long long now_ = clock64(); "
    "atomicAdd(&g_prof[i], static_cast<unsigned long long>(now_ - prof_t)); prof_t = now_; } } while (0)\n")
_MARK = re.compile(r"^(\s*)// PROFILE\((.+)\)$", re.M)
_READER = """
extern "C" int tcf_int8_block_profile(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[8] = {};
    return static_cast<int>(cudaMemcpyToSymbol(g_prof, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_prof, sizeof(unsigned long long) * 8));
}
"""


def instrument(source: str) -> str:
    """The kernel's source with the counters, a clock64 mark at each
    `// PROFILE(phase)` line and `tcf_int8_block_profile`, which reads the
    counters or sets them to 0. Raises unless the source has one
    `// PROFILE_START` and marks that close every phase."""
    if source.count(_START) != 1:
        raise ValueError("csrc/int8_block.cu needs one `// PROFILE_START` line")
    phases = {int(n) for expr in _MARK.findall(source) for n in re.findall(r"\d+", expr[1])}
    if phases != set(range(len(PHASES))):
        raise ValueError(f"csrc/int8_block.cu marks phases {sorted(phases)}, not 0-{len(PHASES) - 1}")
    lines = source.split("\n")
    at = next(i for i, line in enumerate(lines) if line.startswith(_START))
    source = "\n".join(lines[:at]) + "\n" + _SETUP + "\n".join(lines[at + 1:])
    source = _MARK.sub(lambda m: f"{m.group(1)}MARK({m.group(2)});", source)
    return "__device__ unsigned long long g_prof[8];\n" + source + _READER


def _build():
    src = OUT_DIR / "int8_block_profile.cu"
    lib = OUT_DIR / "int8_block_profile.so"
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(instrument((build.CSRC / "int8_block.cu").read_text()))
    r = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} (rc {r.returncode}):\n{r.stdout}{r.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.tcf_int8_block.argtypes = ib._kernel_s2().argtypes
    dll.tcf_int8_block.restype = ctypes.c_int
    dll.tcf_int8_block_profile.argtypes = [ctypes.c_void_p, ctypes.c_int]
    dll.tcf_int8_block_profile.restype = ctypes.c_int
    return dll


def profile_block(dll, seed, block, hw, cin, cmid, cout):
    """{"block", "plan", "shares": {phase: share}, "cycles_a_warp", "ms", "ms_marked"}."""
    x, ops = _inputs(seed, hw, cin, cmid, cout)
    packed = ib.pack_int8_block_s1(**ops)
    want = ib.fused_block_int8_plain(x, **ops)
    out = torch.empty_like(want)
    plan = ib.plan_int8_block_s2(BATCH, hw, hw, cin, cmid, cout)

    def marked():
        rc = dll.tcf_int8_block(x.data_ptr(), packed.data.data_ptr(), out.data_ptr(), *x.shape, cmid, cout,
                                plan.tile_h, plan.tile_w, plan.ck, plan.warps, plan.pm, plan.pn, plan.smem_bytes,
                                plan.grid[0], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"the marked B6 kernel failed to launch with CUDA error {rc}")

    ms_marked = _ms_a_launch(marked)
    counters = (ctypes.c_ulonglong * 8)()
    if dll.tcf_int8_block_profile(counters, 1) != 0:
        raise RuntimeError("could not set the profile's counters to 0")
    out.zero_()
    marked()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise AssertionError(f"the marked B6 kernel differs from its plain version at block {block}")
    if dll.tcf_int8_block_profile(counters, 0) != 0:
        raise RuntimeError("could not read the profile's counters")
    total = sum(counters)
    warps = -(-plan.grid[0] // SAMPLE) * plan.warps
    return {"block": block, "x": [BATCH, hw, hw, cin], "plan": plan.describe(),
            "shares": {name: counters[i] / total for i, name in enumerate(PHASES)},
            "cycles_a_warp": total / warps, "ms": _ms_a_launch(lambda: ib.int8_block_s2(x, packed)),
            "ms_marked": ms_marked}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_b6 needs a CUDA card")
    dll = _build()
    for seed, spec in enumerate(BLOCKS_640):
        print(json.dumps(profile_block(dll, seed, *spec)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
