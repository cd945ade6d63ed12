"""The one-block planar kernel's launch plan and packed weights
(`csrc/planar_chain.cu`, `tcf_planar_block`, B4a), on the CPU.

The kernel runs only on a card, where `chip_smoke.py` and
`kernels/sweep_b4a.py` hold it to its plain version. What it takes from
Python is checked here: the plan of `plan_planar_mbconv` (every output
position in exactly one tile, every project tile in exactly one warp's
rectangle, shared memory, thread blocks an SM and grid within the card's
limits), at every stride-1 block of the default model at every bucket, at
`chip_smoke.py`'s shapes and on a grid of ragged maps; what the planner
refuses; the one-block packing; the index arithmetic the streamed kernel
relies on (its 16-byte row starts and its divisions); the epilogue's
rounding; the wrapper's CPU contract. The plain block itself is held to the
JAX package's Pallas kernel in tests/test_torch_planar_mbconv.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from tpucenterface_torch.config import DEFAULT_BUCKETS, ModelConfig
from tpucenterface_torch.model.backbone import backbone_plan
from tpucenterface_torch.ops import planar_mbconv as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _check_plan(shape, b, h, w, skip, plan=None, sms=T.NUM_SMS):
    """The plan (the planner's unless given) covers every output position of
    the batch exactly once, as the kernel indexes its tiles, and every (M
    tile, N tile) of a tile's project exactly once over the warps; its chunk
    buffers, shared memory, thread blocks an SM, accumulators and grid fit;
    a streamed plan's input rows fit a tensor copy's box."""
    s = T.ChainShape(*shape)
    plan = plan or T.plan_planar_mbconv(s, b, h, w, sms, skip=skip)
    warps, consumers, pmx, pnx, streamed = plan.variant
    assert plan.variant in T.ONE_BLOCK_VARIANTS
    th, tw = plan.tile_h, plan.tile_w
    assert 1 <= th <= h and 1 <= tw <= w and th * tw <= 1024
    chunk, nchunks = T.ChainLayout(s).chunk_bytes, -(-s.ce // T.CHAIN_CK)
    if streamed:
        assert plan.chunk_buffers in {3, max(3, nchunks)}
        iwb = T.block_row_width(tw)
        assert iwb % 8 == 0 and tw + 2 + 7 <= iwb <= 256   # the halo row from any of the 8 shifts
        tile = T.block_tile_smem(th, tw, s.cin)
        assert plan.blocks_per_sm == (2 if plan.smem_bytes <= T.TWO_BLOCKS_SMEM else 1)
    else:
        assert plan.chunk_buffers == 3 and plan.blocks_per_sm == 1
        tile = T.chain_tile_smem(th, tw, s.cin, consumers > 0)
        assert 4 * pmx * pnx + 48 <= T.CHAIN_REGISTERS[plan.variant[:4]]
    assert plan.smem_bytes == plan.chunk_buffers * chunk + tile <= T.MAX_SMEM
    ty, tx = -(-h // th), -(-w // tw)
    items = b * ty * tx
    assert items < 2 ** 24
    assert 1 <= plan.grid == min(items, sms * plan.blocks_per_sm)
    # every tile, position p = oy * tw + ox, masked to the map
    item = np.arange(items)
    img, t = item // (ty * tx), item % (ty * tx)
    oy0, ox0 = (t // tx) * th, (t % tx) * tw
    p = np.arange(th * tw)
    gy = oy0[:, None] + p[None, :] // tw
    gx = ox0[:, None] + p[None, :] % tw
    keep = (gy < h) & (gx < w)
    flat = (np.broadcast_to(img[:, None], gy.shape) * h + gy) * w + gx
    assert (np.bincount(flat[keep], minlength=b * h * w) == 1).all()
    # the project's rectangles: warp -> (mg, ng), PM x PN tiles each
    mt, nt = -(-(th * tw) // 16), -(-s.cout // 8)
    assert 1 <= plan.pm <= pmx and 1 <= plan.pn <= pnx
    ngroups = -(-nt // plan.pn)
    owned = np.zeros((mt, nt), np.int64)
    for warp in range(consumers or warps):
        mg, ng = divmod(warp, ngroups)
        for i in range(plan.pm):
            for j in range(plan.pn):
                m, n = mg * plan.pm + i, ng * plan.pn + j
                if m < mt and n < nt:
                    owned[m, n] += 1
    assert (owned == 1).all()
    return plan


def _model_blocks(size):
    """(block, (Cin, Ce, Cout, expand), skip, map side) of every stride-1
    block of the default model at a `size` input."""
    cfg = ModelConfig(folded=True)
    c, h = cfg.width(cfg.stem_channels), (size - 1) // 2 + 1
    out = []
    for i, (t, cout, s, _) in enumerate(backbone_plan(cfg)):
        h_out = (h - 1) // s + 1
        if s == 1:
            out.append((i, (c, c * t, cout, t != 1), c == cout, h))
        c, h = cout, h_out
    return out


MODEL_CASES = [(size, b, *blk) for size in DEFAULT_BUCKETS for b in (1, 32) for blk in _model_blocks(size)]


def test_model_blocks_are_the_sweeps():
    """The flagship's stride-1 blocks at 640 include the five that
    kernels/sweep_b4a.py times."""
    from tpucenterface_torch.kernels.sweep_b4a import BLOCKS_640

    have = {i: (shape, skip, hw) for i, shape, skip, hw in _model_blocks(640)}
    for block, hw, cin, ce, cout, skip in BLOCKS_640:
        assert have[block] == ((cin, ce, cout, ce != cin), skip, hw)


@pytest.mark.parametrize("size,b,block,shape,skip,hw", MODEL_CASES,
                         ids=[f"{size}_bs{b}_block{i}" for size, b, i, _, _, _ in MODEL_CASES])
def test_plan_covers_every_block_of_the_model(size, b, block, shape, skip, hw):
    _check_plan(shape, b, hw, hw, skip)


SMOKE = chip_smoke.PLANAR_BLOCK_SHAPES


@pytest.mark.parametrize("case", SMOKE, ids=[c[0] for c in SMOKE])
def test_plan_covers_chip_smokes_shapes(case):
    _, b, h, w, c0, [(ce, cout)], _, _ = case
    _check_plan((c0, ce, cout, ce != c0), b, h, w, c0 == cout)


RAGGED = [(50, 70), (1, 1), (320, 320), (23, 37), (1, 200), (200, 1), (41, 161), (7, 255)]


@pytest.mark.parametrize("h,w", RAGGED)
@pytest.mark.parametrize("shape,skip", [((32, 32, 16, False), False), ((24, 144, 24, True), True),
                                        ((160, 960, 160, True), True), ((12, 40, 20, True), False)])
def test_plan_covers_ragged_maps(h, w, shape, skip):
    _check_plan(shape, 2, h, w, skip)


@pytest.mark.parametrize("block", [0, 2, 4, 7, 14])
def test_every_candidate_plan_covers_the_map(block):
    """Every plan the sweep times (`one_block_plans`) is one the kernel takes."""
    _, shape, skip, hw = next(c for c in _model_blocks(640) if c[0] == block)
    plans = list(T.one_block_plans(shape, 32, hw, hw, skip=skip))
    assert plans and any(p.streamed for p in plans) == (shape[0] <= 64)
    for plan in plans:
        _check_plan(shape, 32, hw, hw, skip, plan=plan)


@st.composite
def _shapes(draw):
    cin = draw(st.integers(1, 256))
    expand = draw(st.booleans())
    ce = draw(st.integers(1, 960)) if expand else cin
    cout = cin if draw(st.booleans()) else draw(st.integers(1, 320))
    return (cin, ce, cout, expand), expand and cout == cin


@settings(max_examples=80, deadline=None, derandomize=True)
@given(shape_skip=_shapes(), h=st.integers(1, 320), w=st.integers(1, 320), b=st.integers(1, 3))
def test_plan_covers_the_map_on_a_grid(shape_skip, h, w, b):
    _check_plan(*shape_skip[:1], b, h, w, shape_skip[1])


# the plans kernels/sweep_b4a.py measured within 1% of the fastest at the
# five blocks of a 640 input, batch 32 (NVIDIA H100 80GB HBM3): (variant,
# tile rows, tile columns, chunk buffers, thread blocks an SM). The planner's
# cost model picks one of them.
SWEEP_FASTEST = {
    0: [((8, 0, 2, 2, True), 4, 47, 3, 2)],
    2: [((8, 0, 2, 2, True), 8, 15, 5, 2)],
    4: [((8, 0, 2, 2, True), 4, 31, 6, 2), ((8, 0, 2, 2, True), 8, 15, 6, 2)],
    7: [((16, 0, 2, 4, False), 10, 20, 3, 1)],
    14: [((8, 8, 4, 5, False), 6, 20, 3, 1), ((8, 8, 4, 5, False), 10, 10, 3, 1)],
}


@pytest.mark.parametrize("block", sorted(SWEEP_FASTEST))
def test_planner_picks_the_sweeps_fastest(block):
    _, shape, skip, hw = next(c for c in _model_blocks(640) if c[0] == block)
    plan = T.plan_planar_mbconv(shape, 32, hw, hw, skip=skip)
    assert (plan.variant, plan.tile_h, plan.tile_w, plan.chunk_buffers, plan.blocks_per_sm) in SWEEP_FASTEST[block]


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="Cin <= 256"):
        T.plan_planar_mbconv((264, 528, 264), 1, 4, 4)
    with pytest.raises(ValueError, match="skip without an expand"):
        T.plan_planar_mbconv((16, 16, 16, False), 1, 4, 4, skip=True)
    with pytest.raises(ValueError, match="skip needs Cin == Cout"):
        T.plan_planar_mbconv((16, 96, 24), 1, 4, 4, skip=True)
    with pytest.raises(ValueError, match="without an expand"):
        T.plan_planar_mbconv((16, 32, 16, False), 1, 4, 4)
    with pytest.raises(ValueError, match="non-empty map"):
        T.plan_planar_mbconv((16, 96, 16), 1, 0, 4)
    with pytest.raises(ValueError, match="Cin <= 256"):
        list(T.one_block_plans((300, 300, 8, False), 1, 4, 4))


def _block(rng, c, ce, cout, skip):
    expand = ce != c
    return {
        "w1": torch.from_numpy(rng.randn(c, ce).astype(np.float32)) if expand else None,
        "b1": torch.from_numpy(rng.randn(ce).astype(np.float32)) if expand else None,
        "wd": torch.from_numpy(rng.randn(3, 3, ce).astype(np.float32)),
        "bd": torch.from_numpy(rng.randn(ce).astype(np.float32)),
        "w2": torch.from_numpy(rng.randn(ce, cout).astype(np.float32)),
        "b2": torch.from_numpy(rng.randn(cout).astype(np.float32)),
        "skip": skip,
    }


@pytest.mark.parametrize("c,ce,cout,skip", [(32, 32, 16, False), (24, 144, 24, True), (160, 960, 160, True),
                                            (12, 40, 20, False)])
def test_one_block_packing_round_trips(c, ce, cout, skip):
    """B4a takes the chain kernel's packing of one block: it unpacks to the
    weights it was given (w1 and w2 rounded to bfloat16), in ChainLayout's
    bytes, and the CUDA entry's size check (chunks, then b2) holds."""
    blk = _block(np.random.RandomState(c + ce), c, ce, cout, skip)
    packed = T.pack_planar_chain([blk], c, "cpu")
    s = packed.shapes[0]
    assert packed.shapes == (T.ChainShape(c, ce, cout, ce != c),) and packed.skips == (skip,)
    lay = T.ChainLayout(s)
    assert packed.data.numel() == lay.nbytes == lay.nchunks * lay.chunk_bytes + -(-4 * cout // 16) * 16
    [back] = T.unpack_planar_chain(packed)
    for k in ("w1", "b1", "wd", "bd", "w2", "b2"):
        if blk[k] is None:
            assert back[k] is None
        else:
            assert torch.equal(back[k], blk[k].bfloat16() if k in ("w1", "w2") else blk[k]), k
    assert back["skip"] == skip


@settings(max_examples=200, deadline=None, derandomize=True)
@given(wp=st.integers(3, 700), oy0=st.integers(0, 400), ox0=st.integers(0, 400), tw=st.integers(1, 247))
def test_halo_rows_start_on_16_bytes_and_fit_their_box(wp, oy0, ox0, tw):
    """The streamed kernel's tensor copy of halo row hy starts at
    (flat & ~7), flat = (oy0 - 1 + hy) * Wp + ox0 - 1 (a box's first
    column must lie on 16 bytes, negative flats included), and position hx
    of the row is column (flat & 7) + hx of the box: every one of the
    TW + 2 positions lies inside its IWB columns."""
    iwb = T.block_row_width(tw)
    for hy in range(3):
        flat = (oy0 - 1 + hy) * wp + ox0 - 1
        start = flat & ~7
        assert start % 8 == 0 and start <= flat
        assert flat - start == flat & 7
        assert (flat & 7) + tw + 2 <= iwb


def _magic(d):
    return 0 if d == 1 else ((1 << 32) + d - 1) // d


@pytest.mark.parametrize("d", [1, 2, 3, 5, 6, 7, 9, 17, 31, 32, 47, 63, 100, 255, 1023])
def test_kernel_divisions_by_magic_numbers(d):
    """div_small: n / d as the high 32 bits of n * ceil(2^32 / d) for every
    n below 2^16 (n / 1 is n)."""
    n = np.arange(1 << 16, dtype=np.uint64)
    got = n if d == 1 else (n * np.uint64(_magic(d))) >> np.uint64(32)
    assert np.array_equal(got, n // np.uint64(d))


def test_epilogue_rounding_is_the_cast_of_the_float32_sums():
    """The kernel rounds its float32 sum once to bfloat16 in the epilogue
    (the parent wrote float32 and cast it): `epilogue_bf16`, the plain model
    of __float2bfloat16_rn, equals the cast on random values, on ties of
    both parities, on values that round to infinity, on infinities,
    subnormals and NaN, and on a block's float32 sums."""
    rng = np.random.RandomState(4)
    v = rng.randn(200_000).astype(np.float32) * np.exp2(rng.randint(-140, 120, 200_000)).astype(np.float32)
    bits = rng.randint(0, 1 << 16, 4096).astype(np.uint32) << 16
    ties = np.concatenate([(bits | 0x8000), (bits | 0x7FFF), (bits | 0x8001)]).view(np.float32)
    special = np.array([np.inf, -np.inf, 3.4e38, -3.4e38, 1e-45, -1e-45, 0.0, -0.0, np.nan], np.float32)
    for arr in (v, ties, special):
        t = torch.from_numpy(arr)
        got, want = T.epilogue_bf16(t), t.to(torch.bfloat16)
        nan = torch.isnan(want.float())
        assert torch.equal(torch.isnan(got.float()), nan)
        assert torch.equal(got.view(torch.int16)[~nan], want.view(torch.int16)[~nan])
    # a block: the float32 sums of the plain version, rounded once, are its bfloat16 output
    h, w, c = 6, 9, 16
    blk = _block(rng, c, 48, c, True)
    wp = T.padded_width(h, w)
    x = torch.from_numpy(rng.randn(2, c, h * wp).astype(np.float32)).bfloat16()
    weights = [blk[k] for k in ("w1", "b1", "wd", "bd", "w2", "b2")]
    sums = T._block_plain(T._real_columns(x, h, w, wp), *weights, True, True)
    want = T.planar_mbconv_plain(x, *weights, H=h, W=w, skip=True)
    assert torch.equal(T._to_planar(T.epilogue_bf16(sums).float(), wp).bfloat16(), want)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    rng = np.random.RandomState(6)
    h, w, c = 5, 11, 16
    wp = T.padded_width(h, w)
    x = torch.from_numpy(rng.randn(2, c, h * wp).astype(np.float32)).bfloat16()
    for ce, cout, skip in ((16, 8, False), (96, 16, True)):
        blk = _block(rng, c, ce, cout, skip)
        weights = [blk[k] for k in ("w1", "b1", "wd", "bd", "w2", "b2")]
        before = T.planar_mbconv.launches
        got = T.planar_mbconv(x, *weights, H=h, W=w, skip=skip)
        assert torch.equal(got, T.planar_mbconv_plain(x, *weights, H=h, W=w, skip=skip))
        assert got.dtype == torch.bfloat16 and T.planar_mbconv.launches == before
        with pytest.raises(ValueError, match="packed blocks are for the kernel"):
            T.planar_mbconv(x, T.pack_planar_chain([blk], c, "cpu"), H=h, W=w)
