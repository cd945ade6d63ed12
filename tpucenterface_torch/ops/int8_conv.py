"""int8 1x1 convolution with an int8 requantizing epilogue: the CUDA kernel
`csrc/int8_conv.cu`, its launch plan and its plain version.

Replaces the TPU kernel `tpucenterface/bench/probe_int8_conv.py::
make_pallas_conv1x1_int8` and keeps its contract, planar:

    x (B, Cin, P) int8, w (Cout, Cin) int8, scale and bias (Cout,) float32
    acc = w @ x[b]                      int32 sums
    out = clip(round(acc * scale + bias), -127, 127)  int8, round half to even

The TPU kernel pads Cout to 32 rows, the int8 sublane tile; the port takes
the logical channel counts. The plain version `conv1x1_int8_plain` is the
probe's `xla_fn` (`probe_int8_conv.py:114-122`) in torch. No engine path
runs this kernel: every 1x1 conv of the quantized engine with an int8 output
has an activation ahead of its requantization, and every project emits bf16.

The kernel is a stream over x (see its source): each warp transposes its
pixel step of x in registers into the B fragments of mma.sync and walks
(image, pixel step) items of a persistent grid. `plan_int8_conv1x1` fits the
launch to the shape: the pixels a lane loads from a row (VEC 16, 8 or 4, or
byte loads where P or x's address allows no vector), the m tiles of 16
output channels a warp holds (MT), the K steps of 32 it loads ahead (KC),
the slice of output channels whose weights a block stages in shared memory
(one slice a grid row), the warps of a block and the blocks of a slice.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from tpucenterface_torch.quant.int8_ops import _mm
from tpucenterface_torch.runtime.profiling import counts_work


def _vec(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    """A (n,) or (n, 1) float32 operand as a contiguous (n,) tensor (itself
    where it is one already)."""
    shape = t.shape
    if shape != (n,) and shape != (n, 1):
        raise ValueError(f"{name} must be ({n},) or ({n}, 1), got {tuple(shape)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    return t if len(shape) == 1 and t.is_contiguous() else t.reshape(n).contiguous()


def _check(x, w, scale, bias):
    if x.dim() != 3 or w.dim() != 2 or x.shape[1] != w.shape[1]:
        raise ValueError(f"x must be (B, Cin, P) and w (Cout, Cin), got {tuple(x.shape)}, {tuple(w.shape)}")
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"x and w must be int8, got {x.dtype}, {w.dtype}")
    cout = w.shape[0]
    return _vec(scale, cout, "scale"), _vec(bias, cout, "bias")


def conv1x1_int8_plain(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Plain torch version: int32 product (`quant.int8_ops._mm`), then the
    float32 epilogue with one rounding after the product and one after the
    sum, round half to even, clip to +-127."""
    s, b = _check(x, w, scale, bias)
    bsz, cin, p = x.shape
    acc = _mm(x.permute(0, 2, 1).reshape(-1, cin), w.t())  # (B*P, Cout)
    y = acc.float() * s + b
    return torch.round(y).clamp_(-127, 127).to(torch.int8).reshape(bsz, p, -1).permute(0, 2, 1).contiguous()


# ------------------------------------------------------------------------- #
# the launch plan
# ------------------------------------------------------------------------- #

NUM_SMS = 132          # H100 SXM
MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90
SM_SMEM = 233472       # bytes an SM holds (1,024 of them reserved a block)
SM_REGS = 65536
MAGIC_MAX_CIN = 255    # the sums stay under 2^22 for any int8 operands: the conversion-free epilogue
# (VEC, byte loads, MT, KC) the kernel is compiled for (csrc/int8_conv.cu,
# TCF_B5_VARIANTS), each with both epilogues, and the registers a thread of
# each holds (magic epilogue, cvt epilogue) as nvcc 12.8 compiles them for
# sm_90a (`variant_attributes`; chip_smoke.py fails if the card's kernels
# hold more: the persistent grid is sized to what an SM holds at once)
VARIANT_REGS = {
    (16, False, 1, 1): (166, 166), (16, False, 2, 1): (234, 234), (16, False, 1, 2): (238, 242),
    (8, False, 1, 1): (98, 98), (8, False, 2, 1): (128, 128), (8, False, 4, 1): (204, 204),
    (8, False, 1, 2): (128, 128), (8, False, 2, 2): (168, 168),
    (4, False, 2, 2): (102, 102), (4, True, 2, 2): (100, 100),
}
VARIANTS = tuple(VARIANT_REGS)
WARPS = (4, 8)


@dataclass(frozen=True)
class Int8ConvPlan:
    """One launch of B5: VEC pixels a lane loads from each of its rows (a
    warp step covers 8 * VEC pixels of one image), byte loads and stores or
    vectors, MT m tiles of 16 output channels a warp holds, KC K steps of 32
    a chunk, slice_mt m tiles a block's slice of output channels (grid rows =
    slices), warps a block, blocks a slice (grid columns), the dynamic shared
    memory (the slice's weights in fragment order, its scale and bias), and
    whether the sums start at 1.5 * 2^23 (the conversion-free epilogue).
    Where no slice's weights fit in shared memory (Cin past ~14,000), they
    are read from w at each use (w_smem False)."""

    vec: int
    bytes_io: bool
    mt: int
    kc: int
    slice_mt: int
    w_smem: bool
    warps: int
    blocks: int
    slices: int
    smem_bytes: int
    magic: bool

    @property
    def variant(self):
        return (self.vec, self.bytes_io, self.mt, self.kc)

    @property
    def key(self):
        """(VEC, byte loads, MT, KC, slice m tiles, warps): what the sweep
        names a plan by (the rest follows from the shape)."""
        return (self.vec, self.bytes_io, self.mt, self.kc, self.slice_mt, self.warps)

    def describe(self) -> str:
        io = "byte" if self.bytes_io else f"{self.vec}-byte"
        weights = "" if self.w_smem else " (weights read from w)"
        return (f"VEC {self.vec} ({io} loads), MT {self.mt}, KC {self.kc}, slices of {16 * self.slice_mt} channels "
                f"x {self.slices}{weights}, {self.warps} warps, grid {self.blocks}x{self.slices}, "
                f"{self.smem_bytes} B shared memory, {'magic' if self.magic else 'cvt'} epilogue")


def smem_bytes(cin: int, slice_mt: int, w_smem: bool = True) -> int:
    """A block's dynamic shared memory (csrc/int8_conv.cu): the slice's
    weights, 512 bytes an m tile and K step (if staged), then scale and
    bias."""
    return (slice_mt * -(-cin // 32) * 512 if w_smem else 0) + 128 * slice_mt


def blocks_per_sm(variant, magic: bool, warps: int, smem: int) -> int:
    """Blocks of a variant an SM holds: by registers (a warp's allocated in
    units of 256), by shared memory, by threads."""
    regs = VARIANT_REGS[variant][0 if magic else 1]
    per_warp = -(-regs * 32 // 256) * 256
    return max(0, min(SM_REGS // (per_warp * warps), SM_SMEM // (smem + 1024), 2048 // (32 * warps), 32))


def _alignment(p: int, x_align: int) -> int:
    """The widest vector (16, 8, 4 bytes; 1 for none) that divides P and x's
    address."""
    for v in (16, 8, 4):
        if p % v == 0 and x_align % v == 0:
            return v
    return 1


def int8_conv_plans(b: int, cin: int, p: int, cout: int, x_align: int = 16):
    """Every launch plan of B5 for x (b, cin, p) and Cout that fits: each
    variant whose VEC divides P and x's alignment (byte variants where none
    does), not holding twice the m tiles or K steps the shape has, with each
    slice width (a multiple of MT) whose weights fit, and each block size;
    blocks enough for every warp an item, at most what the SMs hold at once.
    Where no slice's weights fit, the same plans with the weights read from
    w. `x_align` is the largest power of two (up to 16) dividing x's
    address. Raises ValueError on shapes the kernel does not take."""
    if min(b, cin, p, cout) < 1:
        raise ValueError(f"B5 takes a non-empty x and w, got {(b, cin, p, cout)}")
    ks, mts = -(-cin // 32), -(-cout // 16)
    align = _alignment(p, x_align)
    magic = cin <= MAGIC_MAX_CIN
    cands = [v for v in VARIANTS if v[1]] if align < 4 else [v for v in VARIANTS if not v[1] and v[0] <= align]
    w_smem = smem_bytes(cin, 1) <= MAX_SMEM
    for vec, bytes_io, mt, kc in cands:
        family = [v for v in cands if v[0] == vec]
        if mt > min(v[2] for v in family) and mt >= 2 * mts:
            continue
        if kc > min(v[3] for v in family) and kc >= 2 * ks:
            continue
        items = b * -(-p // (8 * vec))
        groups = -(-mts // mt)
        widths = sorted({mt * -(-groups // n) for n in range(1, groups + 1)})
        for slice_mt in widths:
            smem = smem_bytes(cin, slice_mt, w_smem)
            if smem > MAX_SMEM:
                continue
            slices = -(-mts // slice_mt)
            if slices > 65535:
                continue
            for warps in WARPS:
                per_sm = blocks_per_sm((vec, bytes_io, mt, kc), magic, warps, smem)
                if per_sm < 1:
                    continue
                blocks = max(1, min(-(-items // warps), -(-NUM_SMS * per_sm // slices)))
                yield Int8ConvPlan(vec, bytes_io, mt, kc, slice_mt, w_smem, warps, blocks, slices, smem, magic)


# _cost's constants, fitted to kernels/sweep_b5.py at the default model's
# projects (PERF.md section 6): a launch's fixed cost, the bytes a ms a
# stream reaches, a step's memory latency, and the issue time of an
# instruction and of a byte of x a step, for each warp the SM runs at once
LAUNCH_MS, STREAM_BYTES_PER_MS = 7e-3, 2.9e9
STEP_MS, INSTR_MS, BYTE_MS = 1.2e-3, 1.6e-7, 4e-9


def _cost(b, cin, p, cout, plan: Int8ConvPlan) -> float:
    """Estimated device milliseconds of a plan: a fixed launch cost plus
    the larger of the bytes over the rate a stream reaches and the steps a
    warp walks one after another (an item's chunks of each group of each
    slice, over the grid's warps) times a step's cost: its memory latency,
    plus the issue time of its instructions (loads, transposes, mma, the
    epilogue's share) and of its bytes of x for each warp the SM runs at
    once."""
    ks, mts = -(-cin // 32), -(-cout // 16)
    vec, kc, mt = plan.vec, plan.kc, plan.mt
    items = b * -(-p // (8 * vec))
    chunks = -(-ks // kc)
    units = instr = 0
    for s in range(plan.slices):
        m_s = min(plan.slice_mt, mts - s * plan.slice_mt)
        groups = -(-m_s // mt)
        units += groups * chunks
        instr += groups * chunks * (kc * (8 + 4 * vec + mt * (vec + 1)) + 30) + m_s * vec * 30
    warps = plan.blocks * plan.slices * plan.warps
    per_sm = min(blocks_per_sm(plan.variant, plan.magic, plan.warps, plan.smem_bytes) * plan.warps,
                 -(-warps // NUM_SMS))
    chain = items * units / warps
    step = STEP_MS + per_sm * (INSTR_MS * instr / units + BYTE_MS * 256 * vec * kc)
    return LAUNCH_MS + max(b * p * (cin + cout) / STREAM_BYTES_PER_MS, chain * step)


@functools.lru_cache(maxsize=256)
def plan_int8_conv1x1(b: int, cin: int, p: int, cout: int, x_align: int = 16) -> Int8ConvPlan:
    """B5's launch plan for x (b, cin, p) and Cout: of `int8_conv_plans`, the
    one `_cost` finds cheapest. Raises ValueError if none fits."""
    plans = list(int8_conv_plans(b, cin, p, cout, x_align))
    if not plans:
        raise ValueError(f"no B5 plan fits {(b, cin, p, cout)}")
    return min(plans, key=lambda plan: _cost(b, cin, p, cout, plan))


# ------------------------------------------------------------------------- #
# the kernel
# ------------------------------------------------------------------------- #

_P, _I32 = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib():
    from tpucenterface_torch.kernels import build

    return build.load("int8_conv")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The built `tcf_int8_conv1x1` entry point of csrc/int8_conv.cu, typed:
    five pointers, the address of the launch's 13 ints (`_config`), the
    stream."""
    fn = _lib().tcf_int8_conv1x1
    fn.argtypes = [_P] * 7
    fn.restype = _I32
    return fn


@functools.lru_cache(maxsize=256)
def _config(plan: Int8ConvPlan, b: int, cin: int, p: int, cout: int):
    """The ints `tcf_int8_conv1x1` reads for one shape and plan (B, Cin, P,
    Cout, VEC, byte loads, MT, KC, slice m tiles, weights staged, warps,
    blocks, shared memory bytes) as a C array, and its address; the cache
    keeps the array alive."""
    ints = (_I32 * 13)(b, cin, p, cout, plan.vec, int(plan.bytes_io), plan.mt, plan.kc, plan.slice_mt,
                       int(plan.w_smem), plan.warps, plan.blocks, plan.smem_bytes)
    return ints, ctypes.addressof(ints)


def variant_attributes(variant, magic: bool):
    """(registers a thread, local memory bytes a thread) of a compiled
    variant on the current card (`tcf_int8_conv1x1_attr`)."""
    fn = _lib().tcf_int8_conv1x1_attr
    fn.argtypes = [_I32] * 5 + [ctypes.POINTER(_I32)] * 2
    fn.restype = _I32
    regs, local = _I32(), _I32()
    vec, bytes_io, mt, kc = variant
    rc = fn(vec, int(bytes_io), mt, kc, int(magic), ctypes.byref(regs), ctypes.byref(local))
    if rc != 0:
        raise RuntimeError(f"B5 variant {variant} attributes failed with CUDA error {rc}")
    return regs.value, local.value


def _x_align(x: torch.Tensor) -> int:
    ptr = x.data_ptr()
    return 16 if ptr % 16 == 0 else 8 if ptr % 8 == 0 else 4 if ptr % 4 == 0 else 1


def conv1x1_work(x: torch.Tensor, w: torch.Tensor, scale=None, bias=None):
    """(operations, bytes) of one call, as the kernel table's bound counts
    them: the int8 products; x read and out written once (int8), w once, the
    float32 scale and bias once."""
    b, cin, p = x.shape
    cout = w.shape[0]
    return 2 * b * p * cin * cout, b * p * (cin + cout) + cout * cin + 8 * cout


@counts_work("int8_conv1x1", conv1x1_work)
def int8_conv1x1(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """(B, Cin, P) int8 -> (B, Cout, P) int8 (see the module docstring).

    CUDA tensors launch `csrc/int8_conv.cu` (x and w contiguous) with
    `plan_int8_conv1x1`'s plan, cached per shape; CPU tensors take the plain
    version. `int8_conv1x1.launches` counts kernel launches."""
    s, b = _check(x, w, scale, bias)
    dev = x.device
    if dev.type == "cpu":
        return conv1x1_int8_plain(x, w, scale, bias)
    if dev.type != "cuda":
        raise ValueError(f"int8_conv1x1 runs on cuda or cpu, not {dev}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    bsz, cin, p = x.shape
    cout = w.shape[0]
    if bsz * cin * p == 0 or cout == 0:
        raise ValueError(f"empty operands {tuple(x.shape)}, {tuple(w.shape)}")
    index = x.get_device()
    if w.get_device() != index or s.get_device() != index or b.get_device() != index:
        raise ValueError("all operands must be on x's device")
    plan = plan_int8_conv1x1(bsz, cin, p, cout, _x_align(x))
    out = torch.empty((bsz, cout, p), dtype=torch.int8, device=dev)
    launch_int8_conv1x1(x, w, s, b, plan, out)
    int8_conv1x1.launches += 1
    return out


def launch_int8_conv1x1(x, w, s, b, plan: Int8ConvPlan, out) -> None:
    """Launch `csrc/int8_conv.cu` with `plan` into `out`, on operands that
    `int8_conv1x1` has checked (scale and bias as (Cout,) tensors;
    `kernels/sweep_b5.py` times every plan of `int8_conv_plans` through it);
    raises if the kernel refuses the plan or fails to launch. Counts
    nothing. The launch goes to the current stream of x's device (its raw
    handle: no Stream object is built), switching the device only where it
    is not the current one."""
    _, cfg = _config(plan, *x.shape, w.shape[0])
    index = x.get_device()
    args = (x.data_ptr(), w.data_ptr(), s.data_ptr(), b.data_ptr(), out.data_ptr(), cfg,
            torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        rc = _kernel()(*args)
    else:
        with torch.cuda.device(index):
            rc = _kernel()(*args)
    if rc != 0:
        raise RuntimeError(f"int8 conv1x1 kernel launch failed with CUDA error {rc}")


int8_conv1x1.launches = 0
