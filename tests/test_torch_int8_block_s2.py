"""B6's launch plan and the arithmetic its kernel relies on
(`csrc/int8_block.cu`, `tcf_int8_block`), on the CPU.

The kernel runs only on a card, where `chip_smoke.py` and
`kernels/sweep_b6.py` hold it to its plain version bit for bit. What it takes
from Python is checked here:
- the plan of `plan_int8_block_s2`: every output position in exactly one
  tile, every project tile in exactly one warp's rectangle, shared memory and
  grid within the card's limits; at every stride-2 block of the default model
  at every bucket, for every candidate plan at the model's four blocks and at
  `chip_smoke.py`'s shapes, and on a hypothesis grid of ragged and odd maps;
- what the planner and the wrapper refuse;
- the depthwise's stride-2 windows as the kernel forms them (the aligned word
  for an even output column, a byte permutation of two aligned words for an
  odd one) against `dwconv3x3_int8(., stride=2)`;
- the requantizations' float arithmetic (int32 sums started at 1.5 * 2^23,
  the clip folded into the sign of the inverse scale, rounding by an add)
  against the plain `_requant` and the plain epilogue, ties included;
- the wrapper's CPU contract, on packed operands, against the plain version
  and the JAX package's NHWC conv chain;
- the planner's picks against the sweep's fastest plans.
The plain block itself is held to the JAX package's Pallas kernel in
tests/test_torch_int8_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from tpucenterface.bench.probe_fused_block import make_params, xla_nhwc_chain
from tpucenterface_torch.config import DEFAULT_BUCKETS, ModelConfig
from tpucenterface_torch.model.backbone import backbone_plan
from tpucenterface_torch.ops import int8_block as T
from tpucenterface_torch.quant.int8_ops import dwconv3x3_int8
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

KEYS = ("we", "e_scale", "e_bias", "e_inv_sdw", "wd", "d_scale", "d_bias", "d_inv_sproj", "wp", "p_scale", "p_bias")
MAGIC, MAGIC_F = 0x4B400000, np.float32(12582912.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _out_hw(h, w):
    return (h - 1) // 2 + 1, (w - 1) // 2 + 1


def _check_plan(b, h, w, cin, cmid, cout, plan=None):
    """The plan (the planner's unless given) covers every output position of
    the batch exactly once, as the kernel indexes its blocks, and every (M
    tile, N tile) of a tile's project once over the warps; its chunk width,
    shared memory and grid fit."""
    plan = plan or T.plan_int8_block_s2(b, h, w, cin, cmid, cout)
    ho, wo = _out_hw(h, w)
    th, tw = plan.tile_h, plan.tile_w
    assert 1 <= th <= ho and 1 <= tw <= wo and th * tw <= 1024
    ty, tx = -(-ho // th), -(-wo // tw)
    assert plan.grid == (b * ty * tx, 1, 1) and plan.grid[0] < 2 ** 31
    assert plan.ck == T.s1_chunk_width(cmid) and plan.ck in (32, 64)
    assert plan.smem_bytes == T.s2_smem_bytes(th, tw, T.S1Layout(cin, cmid, cout, plan.ck)) <= T.MAX_SMEM
    assert plan.smem_bytes % 16 == 0 and T.s2_blocks_per_sm(plan) >= 1
    assert (plan.warps, plan.pm, plan.pn) in T.S2_VARIANTS
    # every block's tile, position p = oy * tw + ox, masked to the output map
    bid = np.arange(plan.grid[0])
    img, t = bid // (ty * tx), bid % (ty * tx)
    oy0, ox0 = (t // tx) * th, (t % tx) * tw
    p = np.arange(th * tw)
    gy = oy0[:, None] + p[None, :] // tw
    gx = ox0[:, None] + p[None, :] % tw
    keep = (gy < ho) & (gx < wo)
    flat = (np.broadcast_to(img[:, None], gy.shape) * ho + gy) * wo + gx
    assert (np.bincount(flat[keep], minlength=b * ho * wo) == 1).all()
    # the halo of every tile: rows 2 oy0 - 1 .. 2 (oy0 + th) - 1 of x, the
    # inside ones within the map, all of the map covered
    rows = np.zeros(h, np.int64)
    for y0 in range(0, ho, th):
        lo, hi = max(2 * y0 - 1, 0), min(2 * (y0 + th), h)
        rows[lo:hi] += 1
    assert (rows >= 1).all()
    # the project's rectangles: warp -> (mg, ng), PM x PN tiles each
    mt, nt = -(-(th * tw) // 16), cout // 8
    ngroups = -(-nt // plan.pn)
    owned = np.zeros((mt, nt), np.int64)
    for warp in range(plan.warps):
        mg, ng = divmod(warp, ngroups)
        for i in range(plan.pm):
            for j in range(plan.pn):
                m, n = mg * plan.pm + i, ng * plan.pn + j
                if m < mt and n < nt:
                    owned[m, n] += 1
    assert (owned == 1).all()
    return plan


def _model_s2_blocks(size):
    """(block, map side of x, Cin, Cmid, Cout) of every stride-2 block of the
    default model at a `size` input."""
    cfg = ModelConfig(folded=True)
    c, h = cfg.width(cfg.stem_channels), (size - 1) // 2 + 1
    out = []
    for i, (t, cout, s, _) in enumerate(backbone_plan(cfg)):
        if s == 2:
            out.append((i, h, c, c * t, cout))
        c, h = cout, (h - 1) // s + 1
    return out


def test_model_blocks_are_the_sweeps():
    """The flagship's stride-2 blocks at 640 are the four that
    kernels/sweep_b6.py and chip_smoke.py time."""
    from tpucenterface_torch.kernels.sweep_b6 import BLOCKS_640

    assert tuple(_model_s2_blocks(640)) == BLOCKS_640
    assert [b[0] for b in BLOCKS_640] == chip_smoke.QUANT_S2_BLOCKS


MODEL_CASES = [(size, b, *blk) for size in DEFAULT_BUCKETS for b in (1, 32) for blk in _model_s2_blocks(size)]


@pytest.mark.parametrize("size,b,block,hw,cin,cmid,cout", MODEL_CASES,
                         ids=[f"{size}_bs{b}_block{i}" for size, b, i, *_ in MODEL_CASES])
def test_plan_covers_every_block_of_the_model(size, b, block, hw, cin, cmid, cout):
    _check_plan(b, hw, hw, cin, cmid, cout)


SMOKE = chip_smoke.B6_KERNEL_SHAPES


@pytest.mark.parametrize("case", SMOKE, ids=[c[0] for c in SMOKE])
def test_plan_covers_chip_smokes_shapes(case):
    what, shape, _ = case
    plan = _check_plan(*shape)
    ho, wo = _out_hw(*shape[1:3])
    if what.startswith("W one past"):   # one output column past a whole number of tiles
        assert wo % plan.tile_w == 1 and wo > plan.tile_w
    if what.startswith("Cin 16"):       # the expand's K-16 step, on an odd map
        assert shape[3] % 32 == 16 and shape[1] % 2 == shape[2] % 2 == 1
    if what.startswith("Cmid"):         # off the chunk width
        assert shape[4] % plan.ck
    if what.startswith("K 32 then K 16"):
        assert shape[3] > 32 and 0 < shape[3] % 32 <= 16


CANDIDATE_SHAPES = [(32, hw, hw, cin, cmid, cout) for _, hw, cin, cmid, cout in _model_s2_blocks(640)] + [
    c[1] for c in SMOKE]


@pytest.mark.parametrize("shape", CANDIDATE_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_every_candidate_plan_covers_the_map(shape):
    """Every plan the planner weighs (and `kernels/sweep_b6.py` times) is one
    the kernel takes, and the planner's choice is among them."""
    plans = list(T.s2_plans(*shape))
    assert T.plan_int8_block_s2(*shape) in plans
    for plan in plans:
        _check_plan(*shape, plan=plan)


@settings(max_examples=120, deadline=None, derandomize=True)
@given(h=st.integers(1, 200), w=st.integers(1, 200), cin=st.sampled_from([8, 16, 24, 40, 96, 248]),
       cmid=st.integers(8, 960), cout=st.integers(1, 40).map(lambda n: 8 * n), b=st.integers(1, 2))
def test_plan_covers_the_map_on_a_grid(h, w, cin, cmid, cout, b):
    _check_plan(b, h, w, cin, cmid, cout)


@pytest.mark.parametrize("shape,match", [((1, 8, 8, 256, 96, 24), "Cin at most 248"),
                                         ((1, 8, 8, 12, 96, 24), "multiples of 8"),
                                         ((1, 8, 8, 16, 96, 20), "multiples of 8"),
                                         ((1, 0, 8, 16, 96, 24), "non-empty"),
                                         ((0, 8, 8, 16, 96, 24), "non-empty")])
def test_planner_refuses_what_the_kernel_cannot_run(shape, match):
    with pytest.raises(ValueError, match=match):
        list(T.s2_plans(*shape))
    with pytest.raises(ValueError, match=match):
        T.plan_int8_block_s2(*shape)


# --------------------------------------------------------------------------- #
# the arithmetic of the kernel's stages, in numpy
# --------------------------------------------------------------------------- #


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 arrays: byte i of the result is byte
    (sel >> 4 i) & 7 of the eight bytes of (y, x)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        k = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * k)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _dp4a(a, b):
    """Signed __dp4a(a, b, 0) on uint32 words."""
    ab = np.ascontiguousarray(a, np.uint32).view(np.int8).reshape(*a.shape, 4).astype(np.int64)
    bb = np.ascontiguousarray(b, np.uint32).view(np.int8).reshape(*b.shape, 4).astype(np.int64)
    return (ab * bb).sum(-1)


@pytest.mark.parametrize("case", ["random", "extremes"])
@pytest.mark.parametrize("hw", [(9, 14), (16, 16), (1, 1), (7, 33)], ids=lambda s: "x".join(map(str, s)))
def test_stride2_windows_give_the_depthwise_sums(case, hw):
    """Stage B as the kernel runs it: each channel's halo rows (input column
    -1 first, garbage past the map), output column 4 g + j read as the word at
    byte 8 g + 2 j, aligned for even j and __byte_perm(word at 8 g, word at
    8 g + 4, 0x5432) or (8 g + 4, 8 g + 8) for odd j, times the packed tap word
    (w0, w1, w2, 0) of each of three rows with __dp4a: the sums of
    dwconv3x3_int8 at stride 2, bit for bit."""
    rng = np.random.RandomState(sum(hw))
    h, w = hw
    cmid = 40
    ops = [_t(v) for v in (make_params(8, cmid, 8, seed=3)[k] for k in KEYS)]
    if case == "extremes":
        ops[4] = _t(rng.choice([-128, 127], (9, cmid)).astype(np.float32))
        e = rng.choice([-127, 127], (2, h, w, cmid)).astype(np.int8)
    else:
        ops[4] = _t(rng.randint(-128, 128, (9, cmid)).astype(np.float32))
        e = rng.randint(-127, 128, (2, h, w, cmid)).astype(np.int8)
    packed = T.pack_int8_block_s1(*ops)
    lay = packed.layout
    raw = packed.data.numpy()
    words = np.concatenate([raw[k * lay.chunk_bytes + lay.off_taps: k * lay.chunk_bytes + lay.off_vec]
                            .view(np.uint32).reshape(3, lay.ck) for k in range(lay.nchunks)], axis=1)[:, :cmid]
    ho, wo = _out_hw(h, w)
    xg_n = -(-wo // 4)
    rw = 8 * xg_n + 12
    # the halo rows: row 0 and column 0 are the padding at -1, zero; garbage past the map
    rows = rng.randint(0, 256, (2, 2 * ho + 1, rw, cmid)).astype(np.uint8)
    rows[:, :, : w + 2] = 0
    rows[:, 1: h + 1, 1: w + 1] = e.view(np.uint8)
    rows[:, h + 1:, : w + 2] = 0
    got = np.zeros((2, ho, wo, cmid), np.int64)
    for oy in range(ho):
        for ox in range(wo):
            xg, j = divmod(ox, 4)
            for dy in range(3):
                r = rows[:, 2 * oy + dy]                          # (2, rw, cmid) bytes

                def word(at, r=r):
                    return np.ascontiguousarray(r[:, at: at + 4].transpose(0, 2, 1)).view(np.uint32)[..., 0]

                w0, w1, w2 = word(8 * xg), word(8 * xg + 4), word(8 * xg + 8)
                win = {0: w0, 1: _byte_perm(w0, w1, 0x5432), 2: w1, 3: _byte_perm(w1, w2, 0x5432)}[j]
                got[:, oy, ox] += _dp4a(win, np.broadcast_to(words[dy], win.shape))
    want = dwconv3x3_int8(_t(e), ops[4].reshape(3, 3, cmid).to(torch.int8), 2).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "extremes" and h >= 3 and w >= 3:
        assert np.abs(got).max() >= 6 * 127 * 127


def _requant_bits(acc, s, b, inv):
    """The kernel's requant6_bits in numpy float32: the sum started at
    1.5 * 2^23 (its bits, less 1.5 * 2^23, as the float), scale and bias
    rounded each, the clip to [0, 6], the product by |inv| clipped at 127, and
    its sign and the rounding in one add to 1.5 * 2^23 (the product by +-1
    exact); the low byte of the bits, as int8."""
    f = (acc.astype(np.int32) + np.int32(MAGIC)).view(np.float32) - MAGIC_F
    y = np.minimum(np.maximum(f * s + b, np.float32(0)), np.float32(6))
    t = np.minimum(y * np.abs(inv), np.float32(127))
    bits = (t * np.copysign(np.float32(1), inv) + MAGIC_F).astype(np.float32).view(np.uint32)
    return (bits & 0xFF).astype(np.uint8).view(np.int8)


@pytest.mark.parametrize("case", ["random", "ties", "negative_inv"])
def test_requant_bits_match_the_plain_requant(case):
    """Stage A's and stage B's requantization as the kernel computes it equals
    the plain `_requant` (one rounding each, half to even, clip after) bit for
    bit, at sums up to the expand's limit (248 * 128 * 128 < 2^22)."""
    rng = np.random.RandomState(17)
    n, c = 4096, 16
    if case == "ties":   # power-of-two scales: y * inv lands on .5 often
        acc = rng.randint(-100, 400, (n, c)).astype(np.int32)
        s = np.full(c, 2.0 ** -6, np.float32)
        b = np.zeros(c, np.float32)
        inv = np.full(c, 32.0, np.float32)
    else:
        acc = rng.randint(-(2 ** 22) + 1, 2 ** 22, (n, c)).astype(np.int32)
        acc[:8] = [[248 * 128 * 128], [-(248 * 128 * 128)], [0], [1], [-1], [2 ** 22 - 1], [-(2 ** 22) + 1], [7]]
        s = (rng.rand(c) * 2e-5 + 1e-6).astype(np.float32)
        b = (rng.rand(c) * 4 - 2).astype(np.float32)
        inv = (rng.rand(c) * 60 + 1).astype(np.float32)
        if case == "negative_inv":
            inv[::2] *= -1
            inv[1] = np.float32(-0.0)
    got = _requant_bits(acc, s, b, inv)
    want = T._requant(_t(acc), _t(s), _t(b), _t(inv)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "ties":
        y = np.minimum(np.maximum(acc * s, 0), 6) * inv
        assert (np.abs(y - np.floor(y) - 0.5) < 1e-6).mean() > 0.1


def test_epilogue_rounding_matches_the_plain_epilogue():
    """The epilogue's clip127_bits (clip, then an add to 1.5 * 2^23) gives
    clip(round(acc * p_scale + p_bias)) of the plain version, ties included."""
    rng = np.random.RandomState(5)
    acc = rng.randint(-10 ** 6, 10 ** 6, (8192,)).astype(np.int32)
    for scale, bias in ((np.float32(0.5), np.float32(0.0)), (np.float32(1.7e-4), np.float32(0.37)),
                        (np.float32(2.0 ** -12), np.float32(-0.5))):
        v = acc.astype(np.float32) * scale + bias
        bits = (np.minimum(np.maximum(v, np.float32(-127)), np.float32(127)) + MAGIC_F).astype(np.float32)
        got = (bits.view(np.uint32) & 0xFF).astype(np.uint8).view(np.int8)
        want = torch.round(_t(acc).float() * float(scale) + float(bias)).clamp_(-127, 127).to(torch.int8).numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------------------------- #
# the wrapper
# --------------------------------------------------------------------------- #


def _ops(cin, cmid, cout, seed):
    prm = make_params(cin, cmid, cout, seed=seed)
    return {k: _t(prm[k]) for k in KEYS}


@pytest.mark.parametrize("shape", [(2, 13, 19, 8, 24, 32), (1, 9, 32, 16, 40, 24), (2, 1, 5, 24, 72, 16)],
                         ids=["13x19_8-24-32", "9x32_16-40-24", "1x5_24-72-16"])
def test_wrapper_on_the_cpu_matches_plain_and_jax(shape):
    """On the CPU `int8_block_s2(x, packed)` takes the plain version on the
    unpacked operands: equal to `fused_block_int8_plain` on the JAX-layout
    ones and to the JAX package's NHWC conv chain (3x3 / 2, padding 1), with
    no launch counted."""
    b, h, w, cin, cmid, cout = shape
    ops = _ops(cin, cmid, cout, seed=cmid)
    x = _t(np.random.RandomState(cin).randint(-128, 128, (b, h, w, cin)).astype(np.int8))
    before = T.int8_block_s2.launches
    got = T.int8_block_s2(x, T.pack_int8_block_s1(**ops))
    assert T.int8_block_s2.launches == before
    assert got.shape == (b, *_out_hw(h, w), cout) and got.dtype == torch.int8
    assert torch.equal(got, T.fused_block_int8_plain(x, **ops))
    we = jnp.asarray(ops["we"].numpy()).T.reshape(1, 1, cin, cmid)
    wd = jnp.asarray(ops["wd"].numpy().reshape(3, 3, 1, cmid).astype(np.int8))
    wp = jnp.asarray(ops["wp"].numpy()).T.reshape(1, 1, cmid, cout)

    def bc(k):
        return jnp.asarray(ops[k].numpy().reshape(1, 1, 1, -1))

    chain = jax.jit(xla_nhwc_chain(cin, cmid, cout))
    ref = chain(jnp.asarray(x.numpy()), we, bc("e_scale"), bc("e_bias"), bc("e_inv_sdw"), wd, bc("d_scale"),
                bc("d_bias"), bc("d_inv_sproj"), wp, bc("p_scale"), bc("p_bias"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrapper_refuses_what_the_kernel_cannot_run():
    ops = _ops(16, 40, 24, seed=1)
    packed = T.pack_int8_block_s1(**ops)
    x = torch.zeros((1, 9, 9, 16), dtype=torch.int8)
    with pytest.raises(TypeError, match="pack_int8_block_s1"):
        T.int8_block_s2(x, list(ops.values()))
    with pytest.raises(TypeError, match="int8"):
        T.int8_block_s2(x.float(), packed)
    with pytest.raises(TypeError, match="int8"):
        T.int8_block_s2(x[0], packed)
    with pytest.raises(ValueError, match="channels"):
        T.int8_block_s2(torch.zeros((1, 9, 9, 8), dtype=torch.int8), packed)
    with pytest.raises(ValueError, match="contiguous"):
        T.int8_block_s2(x.transpose(1, 2), packed)
    with pytest.raises(ValueError, match="empty"):
        T.int8_block_s2(torch.zeros((0, 9, 9, 16), dtype=torch.int8), packed)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        T.int8_block_s2(x.to("meta"), packed)


# the plans kernels/sweep_b6.py measured within 1% of the fastest at the four
# stride-2 blocks of a 640 input, batch 32 (NVIDIA H100 80GB HBM3, 700 W; the
# medians of three sweeps in one call): (tile rows, tile columns, chunk
# width, warps, PM, PN). The planner's cost model picks one of them.
SWEEP_FASTEST = {
    1: [(8, 32, 32, 8, 2, 3)],
    3: [(8, 16, 32, 8, 2, 3), (8, 16, 32, 8, 2, 4), (16, 8, 32, 8, 2, 3), (16, 8, 32, 8, 2, 4)],
    6: [(10, 20, 64, 16, 1, 12)],
    13: [(10, 10, 64, 16, 1, 12)],
}


@pytest.mark.parametrize("block", sorted(SWEEP_FASTEST))
def test_planner_picks_the_sweeps_fastest(block):
    _, hw, cin, cmid, cout = next(b for b in _model_s2_blocks(640) if b[0] == block)
    plan = T.plan_int8_block_s2(32, hw, hw, cin, cmid, cout)
    assert (plan.tile_h, plan.tile_w, plan.ck, plan.warps, plan.pm, plan.pn) in SWEEP_FASTEST[block]


def test_profile_marks_fit_the_kernel_source():
    """kernels/profile_b6.py turns each `// PROFILE(phase)` line of
    csrc/int8_block.cu into a clock64 mark, starts the counters at
    `// PROFILE_START` and appends their reader; a source whose marks do not
    close every phase is refused."""
    from tpucenterface_torch.kernels import build, profile_b6

    raw = (build.CSRC / "int8_block.cu").read_text()
    src = profile_b6.instrument(raw)
    assert src.count("MARK(") == 9   # the macro and eight marks
    assert all(f"MARK({i});" in src for i in range(1, 8)) and "MARK(k == 0 ? 0 : 6);" in src
    assert "// PROFILE" not in src.replace("// PROFILE_START", "")
    assert src.index("prof_t = clock64()") < src.index("MARK(k == 0 ? 0 : 6);")
    assert 'extern "C" int tcf_int8_block_profile' in src
    with pytest.raises(ValueError, match="not 0-7"):
        profile_b6.instrument(raw.replace("// PROFILE(7)", ""))
    with pytest.raises(ValueError, match="PROFILE_START"):
        profile_b6.instrument(raw.replace("// PROFILE_START", ""))
