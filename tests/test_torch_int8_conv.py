"""B5's launch plan and the index and float arithmetic of its kernel
(`csrc/int8_conv.cu`, `tcf_int8_conv1x1`), on the CPU.

The kernel runs only on a card, where `chip_smoke.py` and
`kernels/sweep_b5.py` hold it to its plain version bit for bit. What it takes
from Python, and the index math it does, are checked here:
- the plan of `plan_int8_conv1x1`: every (image, pixel, output channel)
  stored exactly once by the warps' walk, within the card's limits
  (registers, shared memory, grid); at every project of the default model at
  every bucket at bs1 and bs32, at `chip_smoke.py`'s shapes, at the sweep's,
  and on a hypothesis grid whose P covers every residue mod 16;
- a re-enactment in torch of the kernel's data movement: the lanes' row
  loads, the 4x4 byte transposes by `__byte_perm` (its selectors as index
  maps), the A fragments as the block stages them, mma.sync's fragment
  layouts, the epilogue's bits and the packing of four outputs a word, and
  the D fragments' pixels, against `conv1x1_int8_plain`, bit for bit, on
  every variant;
- the conversion-free epilogue (sums started at 1.5 * 2^23, rounding by an
  add) against the plain epilogue: on tie-heavy operands, on all +-127
  operands at the largest Cin it takes, and one Cin past it, where the plan
  takes the converting epilogue;
- the wrapper on the CPU against the JAX package's Pallas kernel in interpret
  mode at block 0's project on its whole 320x320 map at batch 1;
- the planner's picks against the sweep's fastest plans.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from tpucenterface.bench.probe_int8_conv import make_pallas_conv1x1_int8
from tpucenterface_torch.config import DEFAULT_BUCKETS, ModelConfig
from tpucenterface_torch.kernels import build
from tpucenterface_torch.model.backbone import backbone_plan
from tpucenterface_torch.ops import int8_conv as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

MAGIC, MAGIC_F = 0x4B400000, np.float32(12582912.0)
# csrc/int8_conv.cu's __byte_perm selectors: the transpose of a 4x4 byte
# block (rows r0..r3, pixels j) and the packing of four outputs a word
SEL_PAIR_LO, SEL_PAIR_HI, SEL_WORD_LO, SEL_WORD_HI = 0x5140, 0x7362, 0x5410, 0x7632
SEL_LOW_BYTES = 0x0040


def _cdiv(a, b):
    return -(-a // b)


# --------------------------------------------------------------------------- #
# the shapes
# --------------------------------------------------------------------------- #


def _model_projects(size):
    """(block, H = W of the project's map, Cin = Cmid, Cout) of every block of
    the default model at a `size` input."""
    cfg = ModelConfig(folded=True)
    c, h = cfg.width(cfg.stem_channels), (size - 1) // 2 + 1
    out = []
    for i, (t, cout, s, _) in enumerate(backbone_plan(cfg)):
        h = (h - 1) // s + 1
        out.append((i, h, c * t, cout))
        c = cout
    return out


def test_sweep_shapes_are_the_models_projects():
    """kernels/sweep_b5.py times the default model's distinct projects at a
    640 input (block 0's also at bs128)."""
    from tpucenterface_torch.kernels.sweep_b5 import SHAPES

    projects = {(32, cin, hw * hw, cout) for _, hw, cin, cout in _model_projects(640)}
    assert (32, 32, 320 * 320, 16) in projects
    for shape in SHAPES:
        assert shape in projects or shape == (128, 32, 320 * 320, 16)
    assert {(b, cin, cout) for b, cin, _, cout in SHAPES} >= {
        (32, 32, 16), (32, 96, 24), (32, 144, 24), (32, 144, 32), (32, 192, 64), (32, 576, 160), (32, 960, 320)}


def _check_plan(b, cin, p, cout, plan=None, x_align=16):
    """The plan (the planner's unless given) stores every (image, pixel,
    output channel) exactly once, as the kernel walks its items, groups and
    m tiles; its variant, shared memory, registers and grid fit the card."""
    plan = plan or T.plan_int8_conv1x1(b, cin, p, cout, x_align)
    assert plan.variant in T.VARIANTS and plan.warps in T.WARPS
    assert plan.magic == (cin <= T.MAGIC_MAX_CIN)
    assert plan.smem_bytes == T.smem_bytes(cin, plan.slice_mt, plan.w_smem) <= T.MAX_SMEM
    assert plan.w_smem == (T.smem_bytes(cin, 1) <= T.MAX_SMEM)
    assert T.blocks_per_sm(plan.variant, plan.magic, plan.warps, plan.smem_bytes) >= 1
    regs = T.VARIANT_REGS[plan.variant][0 if plan.magic else 1]
    assert regs <= 255 and regs * 32 * plan.warps <= T.SM_REGS
    vec, npix = plan.vec, 8 * plan.vec
    if plan.bytes_io:
        assert vec == 4 and (p % 4 or x_align % 4)
    else:
        assert p % vec == 0 and x_align % vec == 0
    mts = _cdiv(cout, 16)
    assert plan.slice_mt % plan.mt == 0 or plan.slice_mt >= mts
    assert plan.slices == _cdiv(mts, plan.slice_mt) <= 65535 and 1 <= plan.blocks < 2 ** 31
    steps = _cdiv(p, npix)
    items = b * steps
    assert items < 2 ** 31
    # the warps' walk: warp w of block x starts at item x * warps + w, strided
    # by blocks * warps
    stride = plan.blocks * plan.warps
    visits = np.zeros(items, np.int64)
    for start in range(min(stride, items)):
        visits[start::stride] += 1
    assert (visits == 1).all()
    # within an item, lane (g, t) stores channels 16 m + g and 16 m + g + 8
    # of each m tile m of its groups at pixels p0 + 2 VEC t .. + 2 VEC - 1
    # (two VEC-byte halves), masked past Cout and P. The channels come from g
    # and the pixels from t, so every (channel, pixel) is stored exactly once
    # if the channels of the slices' groups and the pixels of the items'
    # steps each cover their range exactly once.
    g, t = np.arange(8), np.arange(4)
    chans = []
    for s in range(plan.slices):
        co0 = 16 * plan.slice_mt * s
        m_s = min(plan.slice_mt, mts - s * plan.slice_mt)
        for grp in range(_cdiv(m_s, plan.mt)):
            for m in range(grp * plan.mt, min(m_s, (grp + 1) * plan.mt)):
                chans += [co0 + 16 * m + g, co0 + 16 * m + g + 8]
    chans = np.concatenate(chans)
    pix = (np.arange(steps).reshape(-1, 1, 1, 1) * npix + 2 * vec * t.reshape(1, -1, 1, 1)
           + vec * np.arange(2).reshape(1, 1, -1, 1) + np.arange(vec).reshape(1, 1, 1, -1)).ravel()
    assert (np.bincount(chans[chans < cout], minlength=cout) == 1).all()
    assert (np.bincount(pix[pix < p], minlength=p) == 1).all()
    return plan


MODEL_CASES = sorted({(b, cin, hw * hw, cout) for size in DEFAULT_BUCKETS for b in (1, 32)
                      for _, hw, cin, cout in _model_projects(size)})


@pytest.mark.parametrize("shape", MODEL_CASES, ids=lambda s: "x".join(map(str, s)))
def test_plan_covers_every_project_of_the_model(shape):
    _check_plan(*shape)


SMOKE = chip_smoke.B5_KERNEL_SHAPES


@pytest.mark.parametrize("case", SMOKE, ids=[c[0] for c in SMOKE])
def test_plan_covers_chip_smokes_shapes(case):
    what, (b, cin, p, cout), _ = case
    plan = _check_plan(b, cin, p, cout)
    if "magic" in what:
        assert plan.magic == (cin == T.MAGIC_MAX_CIN) and cin in (T.MAGIC_MAX_CIN, T.MAGIC_MAX_CIN + 1)
    if "P = 8 mod 16" in what:
        assert p % 16 == 8 and plan.vec == 8
    if "P = 4 mod 16" in what:
        assert p % 16 == 4 and plan.vec == 4 and not plan.bytes_io
    if "one step" in what:
        assert p < 8 * plan.vec
    if "past shared memory" in what:
        assert not plan.w_smem


def test_chip_smokes_shapes_cover_the_issue_list():
    shapes = [c[1] for c in SMOKE]
    cins = {s[1] for s in shapes}
    couts = {s[3] for s in shapes}
    assert {16, 48, 64, T.MAGIC_MAX_CIN, T.MAGIC_MAX_CIN + 1} <= cins and {8, 24, 160} <= couts
    assert any(s[2] % 16 == 8 for s in shapes) and any(s[2] % 16 == 4 for s in shapes)
    assert any(s[0] == 1 for s in shapes)
    names = [c[0] for c in SMOKE]
    # the three shapes chip_smoke.py held before its list grew
    assert {"ragged 3x24x1001 -> 40", "960 -> 160, P 77", "ties 2x32x4099 -> 16"} <= set(names)


@pytest.mark.parametrize("shape", [(32, 32, 102400, 16), (32, 960, 400, 320), (3, 24, 1001, 40), (2, 960, 77, 160)],
                         ids=lambda s: "x".join(map(str, s)))
def test_every_candidate_plan_covers_the_output(shape):
    """Every plan the planner weighs (and `kernels/sweep_b5.py` times) is one
    the kernel takes, and the planner's choice is among them."""
    plans = list(T.int8_conv_plans(*shape))
    assert T.plan_int8_conv1x1(*shape) in plans
    for plan in plans:
        _check_plan(*shape, plan=plan)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(b=st.integers(1, 3), cin=st.integers(1, 300), p16=st.integers(0, 40), pmod=st.sampled_from([0, 8, 4, 1, 7, 13]),
       cout=st.integers(1, 72), x_align=st.sampled_from([16, 8, 4, 1]))
def test_plan_covers_the_output_on_a_grid(b, cin, p16, pmod, cout, x_align):
    p = 16 * p16 + pmod
    if p == 0:
        p = 16
    _check_plan(b, cin, p, cout, x_align=x_align)


@pytest.mark.parametrize("shape,match", [((0, 8, 16, 8), "non-empty"), ((1, 0, 16, 8), "non-empty"),
                                         ((1, 8, 0, 8), "non-empty"), ((1, 8, 16, 0), "non-empty")])
def test_planner_refuses_empty_operands(shape, match):
    with pytest.raises(ValueError, match=match):
        list(T.int8_conv_plans(*shape))


def test_variants_are_the_kernels():
    """The planner's variants are the ones csrc/int8_conv.cu compiles."""
    src = (build.CSRC / "int8_conv.cu").read_text()
    body = src[src.index("#define TCF_B5_VARIANTS(X)"):src.index("Kernel pick(")]
    compiled = []
    for line in body.splitlines()[1:]:
        line = line.strip().rstrip("\\").strip()
        if line.startswith("X("):
            vec, by, mt, kc = (v.strip() for v in line[2:-1].split(","))
            compiled.append((int(vec), by == "true", int(mt), int(kc)))
    assert tuple(compiled) == T.VARIANTS
    for sel in (SEL_PAIR_LO, SEL_PAIR_HI, SEL_WORD_LO, SEL_WORD_HI, SEL_LOW_BYTES):
        assert f"0x{sel:04x}" in src.lower()
    assert f"kMagicMaxCin = {T.MAGIC_MAX_CIN};" in src


# --------------------------------------------------------------------------- #
# a re-enactment of the kernel in torch
# --------------------------------------------------------------------------- #


def byte_perm(x: torch.Tensor, y: torch.Tensor, sel: int) -> torch.Tensor:
    """CUDA's __byte_perm on 32-bit words held in int64 tensors: byte i of
    the result is byte (sel >> 4 i) & 7 of the eight bytes (x low, y high)."""
    both = (y << 32) | x
    out = torch.zeros_like(x)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        out |= ((both >> (8 * k)) & 0xFF) << (8 * i)
    return out


def _word(bytes4: torch.Tensor) -> torch.Tensor:
    """(..., 4) bytes (0..255, int64) -> (...) little-endian words."""
    return bytes4[..., 0] | bytes4[..., 1] << 8 | bytes4[..., 2] << 16 | bytes4[..., 3] << 24


def _bytes(words: torch.Tensor) -> torch.Tensor:
    """(...) words -> (..., 4) bytes."""
    return torch.stack([(words >> (8 * j)) & 0xFF for j in range(4)], dim=-1)


def _signed(u8: torch.Tensor) -> torch.Tensor:
    return torch.where(u8 >= 128, u8 - 256, u8)


def staged_fragments(w: torch.Tensor, co0: int, mts: int, ks_n: int) -> torch.Tensor:
    """The A fragments a block of slice `co0` stages: (mts, KS, 32 lanes, 4
    words), a0 = w[16 m + g, 32 ks + 4 t ..], a1 = rows + 8, a2 = k + 16, a3 =
    both; zero past Cout and Cin."""
    cout, cin = w.shape
    wp = torch.zeros((max(cout, co0 + 16 * mts), 32 * ks_n), dtype=torch.int64)
    wp[:cout, :cin] = w.to(torch.int64) & 0xFF
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    m = torch.arange(mts).view(-1, 1, 1, 1)
    ks = torch.arange(ks_n).view(1, -1, 1, 1)
    i = torch.arange(4).view(1, 1, 1, 4)
    row = co0 + 16 * m + g.view(1, 1, 32, 1) + 8 * (i & 1)
    k0 = 32 * ks + 4 * t.view(1, 1, 32, 1) + 16 * (i >> 1)
    return _word(torch.stack([wp[row, k0 + j] for j in range(4)], dim=-1))


def lane_rows(xp: torch.Tensor, vec: int, ks: int, items_img, items_p0) -> torch.Tensor:
    """The words lane (g, t) loads in K step ks at each item: (items, 32
    lanes, 8 rows, VEC / 4 words); row i is k = 32 ks + 4 t + (i & 3) + 16 (i >> 2),
    word v pixels p0 + VEC g + 4 v .. + 3 (xp zero past Cin and P)."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    i = torch.arange(8)
    k = 32 * ks + 4 * t.view(32, 1) + (i & 3).view(1, 8) + 16 * (i >> 2).view(1, 8)          # (32, 8)
    v = torch.arange(vec // 4)
    j = torch.arange(4)
    pix = vec * g.view(32, 1, 1, 1) + 4 * v.view(1, 1, -1, 1) + j.view(1, 1, 1, 4)           # (32, 1, W, 4)
    img = items_img.view(-1, 1, 1, 1, 1)
    p = items_p0.view(-1, 1, 1, 1, 1) + pix.unsqueeze(0)
    return _word(xp[img, k.view(1, 32, 8, 1, 1), p])


def transpose(raw: torch.Tensor, vec: int) -> torch.Tensor:
    """csrc/int8_conv.cu `transpose`: (items, 32, 8, W) row words -> (items,
    32, VEC n tiles, 2) B fragment words b[n][h], n = 4 v + j."""
    out = []
    for v in range(vec // 4):
        per_h = []
        for h in range(2):
            r0, r1, r2, r3 = (raw[:, :, 4 * h + i, v] for i in range(4))
            t0, t1 = byte_perm(r0, r1, SEL_PAIR_LO), byte_perm(r0, r1, SEL_PAIR_HI)
            t2, t3 = byte_perm(r2, r3, SEL_PAIR_LO), byte_perm(r2, r3, SEL_PAIR_HI)
            per_h.append(torch.stack([byte_perm(t0, t2, SEL_WORD_LO), byte_perm(t0, t2, SEL_WORD_HI),
                                      byte_perm(t1, t3, SEL_WORD_LO), byte_perm(t1, t3, SEL_WORD_HI)], dim=-1))
        out.append(torch.stack(per_h, dim=-1))            # (items, 32, 4 j, 2 h)
    return torch.cat(out, dim=2)


def mma(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mma.sync.m16n8k32 s8 by its fragment layouts: a (32 lanes, 4 words),
    b (..., 32 lanes, 2 words) -> D (..., 32 lanes, 4) int64 as the lanes
    hold it (c0, c1: row g, columns 2t, 2t+1; c2, c3: row g + 8)."""
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    A = torch.zeros((16, 32), dtype=torch.int64)
    ab = _signed(_bytes(a))                                 # (32, 4 words, 4 bytes)
    for i in range(4):
        for j in range(4):
            A[g + 8 * (i & 1), 4 * t + 16 * (i >> 1) + j] = ab[:, i, j]
    lead = b.shape[:-2]
    B = torch.zeros(lead + (32, 8), dtype=torch.int64)
    bb = _signed(_bytes(b))                                 # (..., 32, 2, 4)
    for h in range(2):
        for j in range(4):
            B[..., 4 * t + 16 * h + j, g] = bb[..., :, h, j]
    D = torch.einsum("mk,...kn->...mn", A, B)               # (..., 16, 8)
    return torch.stack([D[..., g + 8 * (i >> 1), 2 * t + (i & 1)] for i in range(4)], dim=-1)


def requant_bits(acc: torch.Tensor, s: torch.Tensor, b: torch.Tensor, magic: bool) -> torch.Tensor:
    """csrc/int8_conv.cu `requant_bits` in float32: the int8 in the low byte."""
    if magic:
        a = (acc.to(torch.int32).view(torch.float32) - MAGIC_F)
    else:
        a = acc.to(torch.int32).to(torch.float32)
    y = a * s + b
    q = y.clamp(-127.0, 127.0) + MAGIC_F
    return q.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def pack4(q0, q1, q2, q3):
    return byte_perm(byte_perm(q0, q1, SEL_LOW_BYTES), byte_perm(q2, q3, SEL_LOW_BYTES), SEL_WORD_LO)


def reenact(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, plan) -> torch.Tensor:
    """The kernel's output under `plan`, step by step as its warps compute it:
    staged A fragments, lane loads, byte transposes, mma fragments, the
    epilogue's bits packed four a word, stored at the D fragments' pixels."""
    bsz, cin, p = x.shape
    cout = w.shape[0]
    vec, npix = plan.vec, 8 * plan.vec
    ks_n, mts, steps = _cdiv(cin, 32), _cdiv(cout, 16), _cdiv(p, npix)
    xp = torch.zeros((bsz, 32 * ks_n, steps * npix), dtype=torch.int64)
    xp[:, :cin, :p] = x.to(torch.int64) & 0xFF
    item = torch.arange(bsz * steps)
    img, p0 = item // steps, (item % steps) * npix
    raws = [lane_rows(xp, vec, ks, img, p0) for ks in range(ks_n)]
    bfrag = [transpose(r, vec) for r in raws]               # (items, 32, VEC, 2) each
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    out = torch.zeros((bsz, 16 * mts, steps * npix), dtype=torch.int64)
    for s in range(plan.slices):
        co0 = 16 * plan.slice_mt * s
        m_s = min(plan.slice_mt, mts - s * plan.slice_mt)
        frags = staged_fragments(w, co0, m_s, ks_n)
        sc = torch.zeros(16 * m_s, dtype=torch.float32)
        bi = torch.zeros(16 * m_s, dtype=torch.float32)
        n_real = min(16 * m_s, cout - co0)
        sc[:n_real], bi[:n_real] = scale[co0:co0 + n_real], bias[co0:co0 + n_real]
        for m in range(m_s):
            acc = torch.full((bsz * steps, 32, vec, 4), MAGIC if plan.magic else 0, dtype=torch.int64)
            for ks in range(ks_n):
                acc = acc + mma(frags[m, ks], bfrag[ks].transpose(1, 2).reshape(-1, vec, 32, 2)
                                .reshape(bsz * steps, vec, 32, 2)).transpose(1, 2)
            acc = ((acc + 2 ** 31) % 2 ** 32) - 2 ** 31       # int32 wraparound, as the card's sums
            for h in range(2):
                lc = 16 * m + g + 8 * h                        # (32,)
                s_, b_ = sc[lc].view(1, 32, 1), bi[lc].view(1, 32, 1)
                for half in range(2):
                    q = requant_bits(acc[..., 2 * h + half], s_, b_, plan.magic)   # (items, 32, VEC)
                    words = torch.stack([pack4(*(q[..., 4 * v + j] for j in range(4))) for v in range(vec // 4)],
                                        dim=-1)                                    # (items, 32, W)
                    byts = _bytes(words).reshape(bsz * steps, 32, vec)
                    pix = p0.view(-1, 1, 1) + 2 * vec * t.view(1, 32, 1) + vec * half + torch.arange(vec).view(1, 1, -1)
                    out[img.view(-1, 1, 1), (co0 + lc).view(1, 32, 1), pix] = byts
    return _signed(out[:, :cout, :p]).to(torch.int8)


def _operands(seed, b, cin, p, cout, kind="random"):
    gen = torch.Generator().manual_seed(seed)
    if kind == "ties":     # small integers, scale and bias 0.5: half the values land on .5
        x = torch.randint(-3, 4, (b, cin, p), generator=gen, dtype=torch.int8)
        w = torch.randint(-3, 4, (cout, cin), generator=gen, dtype=torch.int8)
        return x, w, torch.full((cout,), 0.5), torch.full((cout,), 0.5)
    if kind == "extreme":  # all +-127, pixels 0 and 1 at the largest sums +-127^2 Cin of channel 0
        x = (torch.randint(0, 2, (b, cin, p), generator=gen) * 254 - 127).to(torch.int8)
        w = (torch.randint(0, 2, (cout, cin), generator=gen) * 254 - 127).to(torch.int8)
        x[:, :, 0], x[:, :, 1] = w[0], -w[0]
        sc = (0.5 + 0.5 * torch.rand(cout, generator=gen)) / (127 * cin)   # the largest sums off the clip
        return x, w, sc, torch.rand(cout, generator=gen) - 0.5
    x = torch.randint(-127, 128, (b, cin, p), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (cout, cin), generator=gen, dtype=torch.int8)
    sc = torch.rand(cout, generator=gen) * 4.0 / (127 * 127 * max(1, cin) ** 0.5)
    return x, w, sc, torch.rand(cout, generator=gen) * 4 - 2


# (b, Cin, P, Cout, x_align) covering every variant: VEC 16, 8 and 4, bytes
# (odd P, and P a multiple of 4 at an unaligned x), one and two K steps and
# ragged K, one and several m tiles, slices, a last step past P
REENACT = [
    (2, 32, 320, 16, 16), (2, 24, 264, 40, 16), (1, 64, 200, 32, 16), (1, 64, 256, 40, 16), (2, 48, 77, 24, 16),
    (1, 96, 100, 72, 16), (2, 16, 36, 8, 16), (1, 40, 48, 24, 4), (2, 33, 23, 17, 16), (1, 40, 45, 72, 16),
]


@pytest.mark.parametrize("shape", REENACT, ids=lambda s: "x".join(map(str, s)))
def test_reenactment_matches_the_plain_version_on_every_plan(shape):
    b, cin, p, cout, x_align = shape
    x, w, sc, bi = _operands(sum(shape), b, cin, p, cout)
    want = T.conv1x1_int8_plain(x, w, sc, bi)
    plans = list(T.int8_conv_plans(b, cin, p, cout, x_align))
    variants = {plan.variant for plan in plans}
    assert plans
    for variant in sorted(variants):
        plan = min((pl for pl in plans if pl.variant == variant), key=lambda pl: (pl.slices, pl.warps))
        assert torch.equal(reenact(x, w, sc, bi, plan), want), plan.describe()


def test_reenactment_covers_every_variant():
    seen = set()
    for b, cin, p, cout, x_align in REENACT:
        seen |= {pl.variant for pl in T.int8_conv_plans(b, cin, p, cout, x_align)}
    assert seen == set(T.VARIANTS)


@pytest.mark.parametrize("kind,cin", [("ties", 32), ("ties", 200), ("extreme", T.MAGIC_MAX_CIN),
                                      ("extreme", T.MAGIC_MAX_CIN + 1)])
def test_reenacted_epilogue_matches_the_plain_one(kind, cin):
    """Tie-heavy operands (round half to even), and all +-127 operands at
    the largest Cin of the magic epilogue (sums up to 127 * 127 * 255, under
    2^22) and one past it (the converting epilogue)."""
    b, p, cout = 1, 40, 16
    x, w, sc, bi = _operands(cin, b, cin, p, cout, kind)
    plan = T.plan_int8_conv1x1(b, cin, p, cout)
    assert plan.magic == (cin <= T.MAGIC_MAX_CIN)
    want = T.conv1x1_int8_plain(x, w, sc, bi)
    assert torch.equal(reenact(x, w, sc, bi, plan), want)
    acc = torch.einsum("ok,bkp->bop", w.long(), x.long())
    if kind == "ties":
        y = acc.float() * 0.5 + 0.5
        assert (y == y.floor() + 0.5).float().mean() > 0.3    # many ties
        assert torch.equal(want.long(), torch.round(y).clamp(-127, 127).long())
    else:
        assert acc.abs().max() == 127 * 127 * cin                 # the largest sums
        assert (128 * 128 * cin < 2 ** 22) == (cin <= T.MAGIC_MAX_CIN)   # -128 * -128 at every k
        assert (want[:, 0, :2].abs() > 60).all()


@settings(max_examples=200, deadline=None, derandomize=True)
@given(acc=st.integers(-(2 ** 22) + 1, 2 ** 22 - 1), s=st.floats(2 ** -20, 4.0, width=32),
       b=st.floats(-200.0, 200.0, width=32))
def test_magic_epilogue_matches_the_plain_one(acc, s, b):
    """Bits started at 1.5 * 2^23 give the sum exactly under 2^22, and
    clipping before the rounding add gives the plain round-then-clip."""
    a = torch.tensor([acc], dtype=torch.int64)
    st_, bt = torch.tensor([s], dtype=torch.float32), torch.tensor([b], dtype=torch.float32)
    got = requant_bits(a + MAGIC, st_, bt, True) & 0xFF
    want = torch.round(a.to(torch.float32) * st_ + bt).clamp(-127, 127).to(torch.int64) & 0xFF
    assert torch.equal(got, want)
    assert torch.equal(requant_bits(a, st_, bt, False) & 0xFF, want)


def test_byte_perm_transpose_is_a_transpose():
    """The four selectors turn rows r0..r3 of four pixels into, for each
    pixel j, the word of its four rows."""
    rows = torch.tensor([[0x03020100, 0x13121110, 0x23222120, 0x33323130]], dtype=torch.int64)
    got = transpose(torch.stack([rows[:, i] for i in range(4)] * 2, dim=1).view(1, 1, 8, 1), 4)
    assert [hex(v) for v in got[0, 0, :, 0].tolist()] == ["0x30201000", "0x31211101", "0x32221202", "0x33231303"]


# --------------------------------------------------------------------------- #
# the wrapper on the CPU
# --------------------------------------------------------------------------- #


def _pallas_conv1x1(x, w, scale, bias, pblk):
    """The Pallas kernel in interpret mode, its Cout padded to the int8
    sublane tile of 32 as the probe pads it, cut back to Cout."""
    import jax.numpy as jnp

    b, cin, npix = x.shape
    cout = w.shape[0]
    wp = np.zeros((32, cin), np.int8)
    wp[:cout] = w
    sp, bp = np.zeros((32, 1), np.float32), np.zeros((32, 1), np.float32)
    sp[:cout, 0], bp[:cout, 0] = scale, bias
    fn = make_pallas_conv1x1_int8(b, cin, 32, npix, pblk, interpret=True)
    return np.asarray(fn(jnp.asarray(wp), jnp.asarray(sp), jnp.asarray(bp), jnp.asarray(x)))[:, :cout]


@pytest.mark.parametrize("scales,b,npix,pblk", [("powers of two", 1, 320 * 320, 10240), ("random", 2, 2048, 1024)],
                         ids=["block0_320x320_bs1_powers_of_two", "bs2_2048_random"])
def test_wrapper_on_the_cpu_matches_the_pallas_kernel_at_block0(scales, b, npix, pblk):
    """Block 0's project (32 -> 16) through the wrapper, against the Pallas
    kernel in interpret mode: on its whole 320x320 map at batch 1, and cut to
    2048 pixels at batch 2. XLA on the CPU contracts the Pallas kernel's
    acc * scale + bias into one fused multiply-add, where the contract (and
    the port) rounds the product and the sum apart. With power-of-two scales
    the product is exact and the two agree bit for bit; with random scales
    every value agrees but those where the single rounding and the double
    one land on opposite sides of a .5, and there each side gives its own
    rounding exactly."""
    cin, cout = 32, 16
    rng = np.random.RandomState(19)
    x = rng.randint(-127, 128, (b, cin, npix), np.int8)
    w = rng.randint(-127, 128, (cout, cin), np.int8)
    if scales == "random":
        scale = (rng.rand(cout) * 1e-3).astype(np.float32)
    else:
        scale = (2.0 ** -rng.randint(8, 12, cout)).astype(np.float32)
    bias = (rng.rand(cout) * 4 - 2).astype(np.float32)
    ref = _pallas_conv1x1(x, w, scale, bias, pblk)
    before = T.int8_conv1x1.launches
    got = T.int8_conv1x1(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale), torch.from_numpy(bias))
    assert T.int8_conv1x1.launches == before
    acc = np.einsum("oc,bcp->bop", w.astype(np.int64), x.astype(np.int64))
    two = np.float32(np.float32(acc) * scale[:, None]) + bias[:, None]           # float32: two roundings
    fused = (acc * scale[:, None].astype(np.float64) + bias[:, None]).astype(np.float32)  # one rounding
    np.testing.assert_array_equal(got.numpy(), np.clip(np.round(two), -127, 127))
    np.testing.assert_array_equal(ref, np.clip(np.round(fused), -127, 127))
    differ = got.numpy() != ref
    if scales == "powers of two":
        assert not differ.any()
    else:
        assert differ.sum() <= 4 and (np.abs(np.asarray(two) - np.asarray(fused))[differ] < 1e-5).all()
    plan = T.plan_int8_conv1x1(b, cin, npix, cout)
    assert torch.equal(reenact(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
                               torch.from_numpy(bias), plan), got)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 8, 16), dtype=torch.int8)
    w = torch.zeros((4, 8), dtype=torch.int8)
    s = torch.ones(4)
    with pytest.raises(TypeError, match="int8"):
        T.int8_conv1x1(x.float(), w, s, s)
    with pytest.raises(ValueError, match="Cin"):
        T.int8_conv1x1(x, w[:, :4], s, s)
    with pytest.raises(ValueError, match="scale"):
        T.int8_conv1x1(x, w, torch.ones(3), s)
    with pytest.raises(TypeError, match="float32"):
        T.int8_conv1x1(x, w, s.double(), s)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        T.int8_conv1x1(x.to("meta"), w.to("meta"), s.to("meta"), s.to("meta"))


def test_plan_is_cached_per_shape():
    T.plan_int8_conv1x1.cache_clear()
    a = T.plan_int8_conv1x1(32, 32, 102400, 16)
    assert T.plan_int8_conv1x1(32, 32, 102400, 16) is a
    assert T.plan_int8_conv1x1.cache_info().hits == 1


# --------------------------------------------------------------------------- #
# the planner against the sweep
# --------------------------------------------------------------------------- #

# the plans kernels/sweep_b5.py measured near the fastest at the default
# model's projects on a 640 input (NVIDIA H100 80GB HBM3, 700 W; the medians
# of five sweeps in two calls): (VEC, byte loads, MT, KC, slice m tiles,
# warps). Within 3% where the fastest takes over 0.04 ms; within 10% at the
# smaller shapes, where the five sweeps spread by 11-62% of a plan's time.
# The planner's cost model picks one of them.
SWEEP_FASTEST = {
    (32, 32, 102400, 16): [(16, False, 1, 1, 1, 4)],
    (32, 96, 25600, 24): [(8, False, 2, 1, 2, 4), (8, False, 2, 1, 2, 8), (8, False, 2, 2, 2, 4)],
    (32, 144, 25600, 24): [(8, False, 2, 2, 2, 4), (8, False, 2, 1, 2, 4)],
    (32, 144, 6400, 32): [(8, False, 2, 1, 2, 4), (8, False, 2, 1, 2, 8), (16, False, 2, 1, 2, 8),
                          (8, False, 2, 2, 2, 4), (16, False, 2, 1, 2, 4)],
    (32, 192, 1600, 64): [(8, False, 2, 1, 2, 8), (8, False, 4, 1, 4, 8), (16, False, 2, 1, 2, 4),
                          (8, False, 2, 1, 2, 4), (8, False, 2, 2, 4, 8), (8, False, 2, 2, 2, 4),
                          (4, False, 2, 2, 2, 4), (8, False, 2, 2, 4, 4), (16, False, 2, 1, 2, 8),
                          (4, False, 2, 2, 2, 8), (16, False, 1, 1, 2, 8)],
    (32, 576, 400, 160): [(4, False, 2, 2, 2, 8), (8, False, 2, 2, 2, 4), (4, False, 2, 2, 2, 4)],
    (32, 960, 400, 320): [(4, False, 2, 2, 4, 8), (4, False, 2, 2, 2, 4), (8, False, 2, 2, 2, 4)],
    (128, 32, 102400, 16): [(16, False, 1, 1, 1, 4)],
}


@pytest.mark.parametrize("shape", sorted(SWEEP_FASTEST), ids=lambda s: "x".join(map(str, s)))
def test_planner_picks_the_sweeps_fastest(shape):
    from tpucenterface_torch.kernels.sweep_b5 import SHAPES

    assert shape in SHAPES
    plan = T.plan_int8_conv1x1(*shape)
    assert plan.key in SWEEP_FASTEST[shape]
