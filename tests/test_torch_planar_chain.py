"""The planar chain kernel's launch plan and packed weights
(`csrc/planar_chain.cu`, B4b), on the CPU.

The kernel runs only on a card, where `chip_smoke.py` holds it to its plain
version block by block. What it takes from Python is checked here: the plan
of `plan_planar_chain` (every output position in exactly one tile, every
project tile in exactly one warp's rectangle, shared memory and registers
within the card's limits), at every chain the planar engine runs at each
bucket, at `chip_smoke.py`'s shapes and on a hypothesis grid; the layout of
`pack_planar_chain`; the wrapper's CPU contract. The plain chain itself is
held to the JAX package's Pallas kernel in tests/test_torch_planar_mbconv.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from tpucenterface_torch.config import DEFAULT_BUCKETS, ModelConfig
from tpucenterface_torch.detector import PLANAR_CHAIN_RES
from tpucenterface_torch.model.backbone import backbone_plan
from tpucenterface_torch.model.planar_engine import chain_runs
from tpucenterface_torch.ops import planar_mbconv as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _check_plan(shapes, b, h, w, plan=None):
    """The plan (the planner's unless given) covers every output position of
    the batch exactly once, as the kernel indexes its tiles, and every (M
    tile, N tile) of a tile's project exactly once over the warps; its shared
    memory, accumulators and grid fit."""
    shapes = tuple(T.ChainShape(*s) for s in shapes)
    plan = plan or T.plan_planar_chain(shapes, b, h, w)
    variant = (plan.producers, plan.consumers, plan.pmx, plan.pnx)
    assert variant in T.CHAIN_VARIANTS and len(plan.blocks) == len(shapes)
    chunk = max(T.ChainLayout(s).chunk_bytes for s in shapes)
    tiles = [T.chain_tile_smem(bp.tile_h, bp.tile_w, s.cin, plan.consumers > 0) for bp, s in zip(plan.blocks, shapes)]
    assert plan.smem_bytes == 3 * chunk + max(tiles) <= T.MAX_SMEM
    most = 0
    for bp, s in zip(plan.blocks, shapes):
        th, tw = bp.tile_h, bp.tile_w
        assert bp.ck == T.CHAIN_CK and 1 <= th <= h and 1 <= tw <= w
        ty, tx = -(-h // th), -(-w // tw)
        items = b * ty * tx
        most = max(most, items)
        assert items < 2 ** 24
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
        assert bp.pm <= plan.pmx and bp.pn <= plan.pnx
        assert 4 * plan.pmx * plan.pnx + 48 <= T.CHAIN_REGISTERS[variant]
        ngroups = -(-nt // bp.pn)
        owned = np.zeros((mt, nt), np.int64)
        for warp in range(plan.consumers or plan.producers):
            mg, ng = divmod(warp, ngroups)
            for i in range(bp.pm):
                for j in range(bp.pn):
                    m, n = mg * bp.pm + i, ng * bp.pn + j
                    if m < mt and n < nt:
                        owned[m, n] += 1
        assert (owned == 1).all()
    assert 1 <= plan.grid == min(most, T.NUM_SMS)
    return plan


def _engine_chains(size):
    """(first block, shapes, map side) of every chain the planar engine runs
    on the default model at a `size` input."""
    cfg = ModelConfig(folded=True)
    plan = backbone_plan(cfg)
    cin, h = [cfg.width(cfg.stem_channels)], [(size - 1) // 2 + 1]
    for t, c, s, _ in plan:
        cin.append(c)
        h.append((h[-1] - 1) // s + 1)
    out = []
    for first, n in chain_runs(cfg, size, PLANAR_CHAIN_RES):
        shapes = [(cin[i], cin[i] * plan[i][0], plan[i][1], plan[i][0] != 1) for i in range(first, first + n)]
        out.append((first, shapes, h[first]))
    return out


# batch 128: the flip program of a TTA batch of 64
ENGINE_CASES = [(size, b, first, shapes, hw) for size in DEFAULT_BUCKETS for b in (1, 32, 128)
                for first, shapes, hw in _engine_chains(size)]


@pytest.mark.parametrize("size,b,first,shapes,hw", ENGINE_CASES,
                         ids=[f"{size}_bs{b}_from{first}" for size, b, first, _, _ in ENGINE_CASES])
def test_plan_covers_every_chain_of_the_engine(size, b, first, shapes, hw):
    plan = _check_plan(shapes, b, hw, hw)
    if (size, b) == (640, 32):   # the flagship chains fill the card
        assert plan.grid == T.NUM_SMS or plan.grid >= 128


def test_engine_chains_are_the_flagships():
    assert [(f, len(s), hw) for f, s, hw in _engine_chains(640)] == [(4, 2, 80), (7, 6, 40), (14, 3, 20)]
    assert [s for _, s, _ in _engine_chains(640)][2] == [(160, 960, 160, True)] * 2 + [(160, 960, 320, True)]


def _smoke_shapes(c0, spec):
    shapes, c = [], c0
    for ce, cout in spec:
        shapes.append((c, ce, cout, ce != c))
        c = cout
    return shapes


SMOKE = chip_smoke.B4B_KERNEL_SHAPES


@pytest.mark.parametrize("case", SMOKE, ids=[c[0] for c in SMOKE])
def test_plan_covers_chip_smokes_shapes(case):
    _, b, h, w, c0, spec, _, _, _ = case
    _check_plan(_smoke_shapes(c0, spec), b, h, w)


@pytest.mark.parametrize("size", [640, 320])
def test_every_candidate_plan_covers_the_map(size):
    """Every plan the sweep times (`chain_plans`) is one the kernel takes."""
    for _, shapes, hw in _engine_chains(size):
        plans = list(T.chain_plans(shapes, 32, hw, hw))
        assert plans
        for plan in plans:
            _check_plan(shapes, 32, hw, hw, plan=plan)


@st.composite
def _chains(draw):
    n = draw(st.integers(1, 16))
    c = draw(st.integers(1, 256))
    shapes = []
    for _ in range(n):
        expand = draw(st.booleans())
        ce = draw(st.integers(1, 960)) if expand else c
        cout = draw(st.integers(1, 320 if len(shapes) + 1 == n else 256))
        shapes.append((c, ce, cout, expand))
        c = cout
    return shapes


@settings(max_examples=120, deadline=None, derandomize=True)
@given(shapes=_chains(), h=st.integers(1, 80), w=st.integers(1, 200), b=st.integers(1, 2))
def test_plan_covers_the_map_on_a_grid(shapes, h, w, b):
    _check_plan(shapes, b, h, w)


def test_plan_refuses_what_the_kernel_cannot_run():
    with pytest.raises(ValueError, match="1 to 16 blocks"):
        T.plan_planar_chain(((8, 8, 8),) * 17, 1, 4, 4)
    with pytest.raises(ValueError, match="Cin <= 256"):
        T.plan_planar_chain(((264, 264, 8),), 1, 4, 4)
    with pytest.raises(ValueError, match="block 1 takes 16"):
        T.plan_planar_chain(((8, 48, 24), (16, 96, 16)), 1, 4, 4)
    with pytest.raises(ValueError, match="without an expand"):
        T.plan_planar_chain(((8, 16, 8, False),), 1, 4, 4)


def _blocks(rng, c0, spec):
    blocks, c = [], c0
    for ce, cout in spec:
        expand = ce != c
        blocks.append({
            "w1": torch.from_numpy(rng.randn(c, ce).astype(np.float32)) if expand else None,
            "b1": torch.from_numpy(rng.randn(ce).astype(np.float32)) if expand else None,
            "wd": torch.from_numpy(rng.randn(3, 3, ce).astype(np.float32)),
            "bd": torch.from_numpy(rng.randn(ce).astype(np.float32)),
            "w2": torch.from_numpy(rng.randn(ce, cout).astype(np.float32)),
            "b2": torch.from_numpy(rng.randn(cout).astype(np.float32)),
            "skip": c == cout,
        })
        c = cout
    return blocks


PACK_CASES = {"flagship 14-16": (160, [(960, 160), (960, 160), (960, 320)]), "odd": (12, [(40, 12), (12, 12), (70, 37)]),
              "Ce 136": (32, [(136, 32), (200, 24)]), "one": (8, [(8, 8)])}


@pytest.mark.parametrize("name", list(PACK_CASES))
def test_packing_round_trip_and_layout(name):
    """pack_planar_chain unpacks to the weights it was given (w1 and w2
    rounded to bfloat16), every chunk is a 16-byte aligned slab, and every
    byte outside the weights' places (row padding, channels past Ce, Cin and
    Cout, the tail) is zero."""
    c0, spec = PACK_CASES[name]
    blocks = _blocks(np.random.RandomState(len(name)), c0, spec)
    packed = T.pack_planar_chain(blocks, c0, "cpu")
    assert packed.data.dtype == torch.uint8 and packed.data.device.type == "cpu"
    assert packed.skips == tuple(bl["skip"] for bl in blocks)
    layouts = [T.ChainLayout(s) for s in packed.shapes]
    assert packed.data.numel() == sum(lay.nbytes for lay in layouts)
    for blk, back in zip(blocks, T.unpack_planar_chain(packed)):
        for k in ("w1", "b1", "wd", "bd", "w2", "b2"):
            if blk[k] is None:
                assert back[k] is None
                continue
            want = blk[k].bfloat16() if k in ("w1", "w2") else blk[k]
            assert torch.equal(back[k], want), k
        assert back["skip"] == blk["skip"]
    used = np.zeros(packed.data.numel(), bool)
    for lay, at in zip(layouts, packed.offsets):
        s, ck = lay.shape, T.CHAIN_CK
        assert at % 16 == 0 and lay.chunk_bytes % 16 == 0
        assert all(o % 16 == 0 for o in (lay.off_w2, lay.off_taps, lay.off_b1, lay.off_bd))
        for k in range(lay.nchunks):
            n = min(ck, s.ce - k * ck)
            base = at + k * lay.chunk_bytes
            if s.expand:
                used[base: base + lay.off_w2].reshape(ck, lay.xw, 2)[:n, : s.cin] = True
                used[base + lay.off_b1: base + lay.off_bd].reshape(ck, 4)[:n] = True
            used[base + lay.off_w2: base + lay.off_taps].reshape(lay.n2, lay.w2s, 2)[: s.cout, :n] = True
            used[base + lay.off_taps: base + lay.off_b1].reshape(9, ck, 4)[:, :n] = True
            used[base + lay.off_bd: base + lay.chunk_bytes].reshape(ck, 4)[:n] = True
        tail = at + lay.nchunks * lay.chunk_bytes
        used[tail: tail + 4 * s.cout] = True
    assert not packed.data.numpy()[~used].any()


def test_pack_refuses_what_the_kernel_cannot_run():
    rng = np.random.RandomState(3)
    with pytest.raises(ValueError, match="1 to 16 blocks"):
        T.pack_planar_chain(_blocks(rng, 8, [(8, 8)] * 17), 8, "cpu")
    with pytest.raises(ValueError, match="at most 256 input channels"):
        T.pack_planar_chain(_blocks(rng, 264, [(264, 8)]), 264, "cpu")
    with pytest.raises(ValueError, match="w1 must be"):
        T.pack_planar_chain(_blocks(rng, 8, [(16, 8)]), 12, "cpu")


def test_cpu_wrapper_takes_the_dicts_and_refuses_a_packed_chain():
    """On the CPU the wrapper is the plain chain and counts no launch; a
    PackedChain (also one of one block, as the one-block kernel takes it) is
    for the kernel."""
    rng = np.random.RandomState(5)
    c0, h, w = 12, 5, 9
    blocks = _blocks(rng, c0, [(40, 12), (12, 12), (24, 20)])
    for blk in blocks:   # small enough that the bf16 chain stays finite
        blk["w2"] = blk["w2"] * 0.1
    wp = T.padded_width(h, w)
    x = torch.from_numpy(rng.randn(2, c0, h * wp).astype(np.float32)).bfloat16()
    before = T.planar_mbconv_chain.launches
    got = T.planar_mbconv_chain(x, blocks, H=h, W=w)
    assert torch.equal(got, T.planar_mbconv_chain_plain(x, blocks, H=h, W=w))
    assert T.planar_mbconv_chain.launches == before
    packed = T.pack_planar_chain(blocks, c0, "cpu")
    with pytest.raises(ValueError, match="packed blocks are for the kernel"):
        T.planar_mbconv_chain(x, packed, H=h, W=w)
    with pytest.raises(ValueError, match="packed blocks are for the kernel"):
        T.planar_mbconv_chain(x, T.pack_planar_chain(blocks[:1], c0, "cpu"), H=h, W=w)
