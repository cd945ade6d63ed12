"""B3's launch plan and packed weights (`tpucenterface_torch/ops/fused_mbconv.py`
over `csrc/mbconv.cu`), on the CPU.

The kernel runs only on the card; what surrounds it is checked here:
- `plan_fused_mbconv` covers the map (every output position in one tile,
  every output channel in one block's rectangles, one group of them at the
  model's shapes) within the shared memory a block may use, for every block
  that `model/fast_forward.py::kernel_blocks` sends to the kernel at every
  bucket at batch 1, 32 and 128, of the default model (also at batch 2 and
  8, the serving rungs) and of the `large` preset, and at `chip_smoke.py`'s
  ragged shapes; so does every candidate
  of `fused_mbconv_plans`;
- the planner refuses what the kernel cannot run;
- `pack_fused_mbconv` / `unpack_fused_mbconv` round-trip bit for bit, and the
  packed bytes are laid out as the kernel reads them;
- `fused_mbconv` on a `PackedMBConv` equals the call on the six tensors;
- `FastEngine` packs every block once and hands the kernel the packed record;
- the variants the planner offers are the ones the kernel instantiates.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpucenterface_torch.model.fast_forward as ff
from tpucenterface_torch.config import DEFAULT_BUCKETS, ModelConfig, preset
from tpucenterface_torch.model.backbone import backbone_plan
from tpucenterface_torch.model.centernet import init_model
from tpucenterface_torch.ops import fused_mbconv as fm
from tpucenterface_torch.weights.fold import fold_variables
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "tpucenterface_torch" / "csrc" / "mbconv.cu"


def _engine_shapes(input_h: int, cfg: ModelConfig = ModelConfig(folded=True)):
    """(map, Cin, Ce, Cout, expand) of every block the fast engine sends to
    the kernel at an `input_h` input of the model `cfg` (the default one)."""
    fused = set(ff.kernel_blocks(cfg, input_h))
    hw = (input_h - 1) // 2 + 1
    cin, out = cfg.width(cfg.stem_channels), []
    for i, (t, c, s, _) in enumerate(backbone_plan(cfg)):
        if i in fused:
            out.append((hw, cin, cin * t, c, t != 1))
        hw = (hw - 1) // s + 1
        cin = c
    return out


def _covers(plan: fm.MBConvPlan, b, h, w, cin, ce, cout, expand):
    """The checks the kernel's `derive` makes, and coverage of the map and
    of the output channels."""
    th, tw = plan.tile_h, plan.tile_w
    assert 1 <= th <= h and 1 <= tw <= w
    assert plan.tiles == b * -(-h // th) * -(-w // tw)
    resident = fm.mbconv_blocks_per_sm(plan.warps, plan.pm, plan.pn, plan.smem_bytes) * fm.NUM_SMS
    assert plan.grid == (min(plan.tiles, max(1, resident // plan.grid[1])), -(-cout // plan.cout_group), 1)
    assert plan.cout_group % 8 == 0 and plan.cout_group >= 8
    assert (plan.grid[1] - 1) * plan.cout_group < cout <= plan.grid[1] * plan.cout_group
    mt = -(-th * tw // 16)
    assert -(-mt // plan.pm) * -(-plan.cout_group // 8 // plan.pn) <= plan.warps
    assert (plan.warps, plan.pm, plan.pn) in fm.MBCONV_VARIANTS
    assert plan.ck == fm.mbconv_chunk_width(ce)
    lay = fm.MBConvLayout(cin, ce, cout, plan.ck, expand)
    assert plan.smem_bytes == fm.mbconv_smem_bytes(th, tw, lay) <= fm.MAX_SMEM
    # every part of the shared memory and of a chunk 16-byte aligned
    assert lay.xs * 2 % 16 == 0 and lay.cw * 2 % 16 == 0 and lay.chunk_bytes % 16 == 0
    assert lay.nchunks * plan.ck >= ce and lay.cin_pad >= cin


# 128: the flip program of a TTA batch of 64; 2 and 8: the rungs of an
# eight-stream serving pipeline (chip_smoke.py's `[serving]`)
@pytest.mark.parametrize("batch", [1, 2, 8, 32, 128])
@pytest.mark.parametrize("input_h", [640, 320, 800, 1024, 416, 512])
def test_plan_covers_every_engine_block(input_h, batch):
    shapes = _engine_shapes(input_h)
    assert len(shapes) == len(ff.kernel_blocks(ModelConfig(folded=True), input_h)) >= 4
    for hw, cin, ce, cout, expand in shapes:
        plan = fm.plan_fused_mbconv(batch, hw, hw, cin, ce, cout, expand)
        _covers(plan, batch, hw, hw, cin, ce, cout, expand)
        if cout <= 96:
            # every output channel of the model's blocks in one pass
            assert plan.grid[1] == 1, (hw, cin, ce, cout, plan)


@pytest.mark.parametrize("batch", [1, 32, 128])
@pytest.mark.parametrize("input_h", DEFAULT_BUCKETS)
def test_plan_covers_every_large_preset_block(input_h, batch):
    """The `large` preset (width 1.4: Cin up to 136, Ce up to 816) at every
    bucket: the blocks the fast engine sends to the kernel, each covered."""
    shapes = _engine_shapes(input_h, dataclasses.replace(preset("large").model, folded=True))
    assert len(shapes) >= 4 and max(cin for _, cin, _, _, _ in shapes) <= fm.MAX_CIN
    for hw, cin, ce, cout, expand in shapes:
        _covers(fm.plan_fused_mbconv(batch, hw, hw, cin, ce, cout, expand), batch, hw, hw, cin, ce, cout, expand)


# chip_smoke.py's ragged cases: (B, H, W, Cin, Ce, Cout, expand)
RAGGED = [(2, 26, 38, 24, 144, 24, True), (2, 26, 38, 16, 96, 24, True), (2, 26, 38, 32, 32, 16, False),
          (2, 19, 33, 160, 960, 320, True)]


@pytest.mark.parametrize("shape", RAGGED)
def test_plan_covers_the_ragged_shapes(shape):
    _covers(fm.plan_fused_mbconv(*shape), *shape)


@pytest.mark.parametrize("shape", [(32, hw, hw, cin, ce, cout, ex) for hw, cin, ce, cout, ex in _engine_shapes(640)]
                         + [(1, 32, 32, 160, 960, 320, True),
                            (3, 17, 29, fm.MAX_CIN, 6 * fm.MAX_CIN, fm.MAX_CIN, True)] + RAGGED)
def test_every_candidate_covers_the_map(shape):
    plans = list(fm.fused_mbconv_plans(*shape))
    assert plans and fm.plan_fused_mbconv(*shape) in plans
    for plan in plans:
        _covers(plan, *shape)


def test_plans_exist_for_every_width_up_to_max_cin():
    for cin in range(8, fm.MAX_CIN + 1, 8):
        for cout in (8, cin, 320):
            _covers(fm.plan_fused_mbconv(2, 40, 40, cin, 6 * cin, cout), 2, 40, 40, cin, 6 * cin, cout, True)
        _covers(fm.plan_fused_mbconv(2, 40, 40, cin, cin, 16, False), 2, 40, 40, cin, cin, 16, False)


@pytest.mark.parametrize("shape,match", [
    ((2, 8, 8, 12, 48, 16), "multiples of 8"),
    ((2, 8, 8, 16, 44, 16), "multiples of 8"),
    ((2, 8, 8, 16, 48, 20), "multiples of 8"),
    ((2, 8, 8, fm.MAX_CIN + 8, 48, 16), "Cin <="),
    ((0, 8, 8, 16, 48, 16), "empty"),
    ((2, 8, 0, 16, 48, 16), "empty"),
])
def test_planner_refuses_what_the_kernel_cannot_run(shape, match):
    with pytest.raises(ValueError, match=match):
        fm.plan_fused_mbconv(*shape)


def test_planner_refuses_no_expand_with_another_width():
    with pytest.raises(ValueError, match="Ce must equal Cin"):
        fm.plan_fused_mbconv(2, 8, 8, 32, 64, 16, False)


def _weights(rng, cin, ce, cout, expand, dtype=torch.float32):
    def t(*shape, scale=0.3):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32)).to(dtype)

    w1, b1 = (t(cin, ce), t(ce, scale=0.1)) if expand else (None, None)
    return w1, b1, t(3, 3, ce), t(ce, scale=0.1), t(ce, cout), t(cout, scale=0.1)


@pytest.mark.parametrize("cin,ce,cout,expand", [
    (24, 144, 24, True),    # Cin padded to 32, Ce to chunks of 48
    (32, 32, 16, False),    # no expand, Cout 16
    (96, 576, 96, True),    # Cout 96
    (160, 960, 320, True),  # Cout 320
    (16, 200, 40, True),    # Ce 200 in chunks of 32, the last one ragged
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pack_round_trips_bit_for_bit(cin, ce, cout, expand, dtype):
    args = _weights(np.random.RandomState(cin + ce), cin, ce, cout, expand, dtype)
    packed = fm.pack_fused_mbconv(*args)
    assert isinstance(packed, fm.PackedMBConv) and packed.data.dtype == torch.uint8
    assert packed.data.numel() == packed.layout.nbytes and (packed.cin, packed.ce, packed.cout) == (cin, ce, cout)
    assert packed.expand == expand and packed.device == torch.device("cpu")
    back = fm.unpack_fused_mbconv(packed)
    for a, b in zip(args, back):
        if a is None:
            assert b is None
            continue
        assert b.dtype == torch.bfloat16 and b.shape == a.shape
        assert torch.equal(b, a.bfloat16())


def test_packed_layout_is_the_kernels():
    """Chunk 1 of a 24->144->24 block: w1 transposed with zeros past Cin,
    w2 rows of every output channel with zeros past the chunk, the taps, b1
    and bd as float32, each where csrc/mbconv.cu reads it; b2 after the
    chunks."""
    w1, b1, wd, bd, w2, b2 = _weights(np.random.RandomState(7), 24, 144, 24, True, torch.bfloat16)
    packed = fm.pack_fused_mbconv(w1, b1, wd, bd, w2, b2)
    lay = packed.layout
    assert (lay.ck, lay.cin_pad, lay.xs, lay.cw, lay.nchunks) == (48, 32, 40, 56, 3)
    chunk = packed.data[lay.chunk_bytes : 2 * lay.chunk_bytes]
    w1s = chunk[: lay.off_w2].view(torch.bfloat16).reshape(48, 40)
    assert torch.equal(w1s[:, :24], w1[:, 48:96].t()) and not w1s[:, 24:].float().any()
    w2s = chunk[lay.off_w2 : lay.off_taps].view(torch.bfloat16).reshape(24, 56)
    assert torch.equal(w2s[:, :48], w2[48:96].t()) and not w2s[:, 48:].float().any()
    vec = chunk[lay.off_taps :].clone().view(torch.float32).reshape(11, 48)
    assert torch.equal(vec[:9], wd.float().reshape(9, 144)[:, 48:96])
    assert torch.equal(vec[9], b1[48:96].float()) and torch.equal(vec[10], bd[48:96].float())
    tail = packed.data[3 * lay.chunk_bytes :].clone().view(torch.float32)
    assert torch.equal(tail[:24], b2.float()) and not tail[24:].any()


@pytest.mark.parametrize("cin,ce,cout,expand,skip,relu6", [
    (24, 144, 24, True, True, True),
    (16, 96, 24, True, False, True),
    (32, 32, 16, False, False, True),
    (32, 192, 32, True, True, False),
])
def test_packed_call_equals_the_six_tensor_call(cin, ce, cout, expand, skip, relu6):
    rng = np.random.RandomState(cin * 3 + ce)
    args = _weights(rng, cin, ce, cout, expand)
    x = torch.from_numpy((rng.randn(2, 9, 13, cin) * 0.5).astype(np.float32)).bfloat16()
    packed = fm.pack_fused_mbconv(*args)
    before = fm.fused_mbconv.launches
    got = fm.fused_mbconv(x, packed, skip=skip, relu6=relu6)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 9, 13, cout)
    assert torch.equal(got, fm.fused_mbconv(x, *args, skip=skip, relu6=relu6))
    assert torch.equal(got, fm.fused_mbconv_plain(x, *args, skip=skip, relu6=relu6))
    assert fm.fused_mbconv.launches == before


def test_packed_call_refuses_what_does_not_fit():
    rng = np.random.RandomState(11)
    args = _weights(rng, 16, 96, 24, True)
    packed = fm.pack_fused_mbconv(*args)
    x = torch.zeros(1, 4, 4, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="channels"):
        fm.fused_mbconv(torch.zeros(1, 4, 4, 24, dtype=torch.bfloat16), packed, skip=False)
    with pytest.raises(ValueError, match="skip"):
        fm.fused_mbconv(x, packed, skip=True)
    with pytest.raises(TypeError, match="PackedMBConv"):
        fm.fused_mbconv(x, packed, args[1], skip=False)
    with pytest.raises(ValueError, match="x must be"):
        fm.fused_mbconv(x[0], packed, skip=False)
    with pytest.raises(ValueError, match="multiples of 8"):
        fm.pack_fused_mbconv(*_weights(rng, 12, 96, 24, True))
    with pytest.raises(ValueError, match="packed weights are on meta"):
        fm.fused_mbconv(x, fm.pack_fused_mbconv(*args, device="meta"), skip=False)


def test_fast_engine_packs_once_and_passes_the_packed_record(monkeypatch):
    cfg = ModelConfig(folded=True)
    _, variables = init_model(ModelConfig(), seed=3)
    eng = ff.FastEngine(fold_variables(variables), cfg, use_mbconv_kernel=True, min_kernel_hw=4, device="cpu")
    stride1 = [i for i, (_, _, s, _) in enumerate(backbone_plan(cfg)) if s == 1]
    assert sorted(eng.packed) == stride1
    assert all(isinstance(p, fm.PackedMBConv) for p in eng.packed.values())
    assert not hasattr(eng, "kernel_args")

    def no_packing(*a, **k):
        raise AssertionError("the engine packs at build, not in the forward")

    seen = []

    def recording(x, packed, *rest, **kw):
        assert not rest and set(kw) == {"skip", "relu6"}
        seen.append(packed)
        return fm.fused_mbconv(x, packed, **kw)

    monkeypatch.setattr(ff, "pack_fused_mbconv", no_packing)
    monkeypatch.setattr(fm, "pack_fused_mbconv", no_packing)
    monkeypatch.setattr(ff, "fused_mbconv", recording)
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 64, 64, 3).astype(np.float32))
    with torch.inference_mode():
        eng(x)
    blocks = eng.kernel_blocks(64)
    assert len(seen) == len(blocks) == 10
    assert all(p is eng.packed[i] for p, i in zip(seen, blocks))


def test_kernel_instantiates_the_planners_variants():
    """Each (warps, PM, PN) of MBCONV_VARIANTS is dispatched by the kernel,
    and its blocks an SM (MBCONV_BLOCKS_PER_SM) are the kernel's launch
    bounds (`occupancy`)."""
    src = CSRC.read_text()
    dispatched = {tuple(map(int, m)) for m in re.findall(r"warps == (\d+) && pm == (\d+) && pn == (\d+)", src)}
    assert dispatched == set(fm.MBCONV_VARIANTS)
    body = re.search(r"constexpr int occupancy\(int nw\) \{ return (.*?); \}", src).group(1)
    assert body == "nw == 16 ? 1 : 2"
    for (nw, pm, pn), blocks in fm.MBCONV_BLOCKS_PER_SM.items():
        assert blocks == (1 if nw == 16 else 2), (nw, pm, pn)
    assert "kSpare = 4" in src and fm._SPARE == 4
    assert set(re.findall(r"ck != (\d+)", src)) == {str(c) for c in fm.MBCONV_CHUNKS}


def test_sweep_imports_leave_jax_out():
    """The B3 sweep and the B1 timer import nothing of JAX."""
    code = ("import sys; import tpucenterface_torch.kernels.sweep_b3, tpucenterface_torch.ops.fused_mbconv, "
            "tpucenterface_torch.decode.fused_nms, tpucenterface_torch.kernels.time_b1; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tpucenterface')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr
