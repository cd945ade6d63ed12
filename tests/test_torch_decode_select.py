"""B2's two-stage selection and launch plan (`decode/fused_decode.py`) on the CPU.

The kernel (`csrc/decode.cu`) runs only on a card, where `chip_smoke.py`
holds it to `decode_feats_fused_plain`. Here:
- the kernel's key order (`peak_keys`) is the order of a stable descending
  sort;
- `select_banded_plain`, the model of the kernel's selection (each band's
  top K' by key, then the top K of their union), equals `topk_lowest_index`
  (the plain version's top-K, lax.top_k's order) and JAX's `lax.top_k` on
  the fixtures of tests/test_torch_decode.py and on maps that stress the
  selection, under every band height the planner weighs;
- `plan_decode` and every plan of `decode_plans` cover the map (every row in
  exactly one band, K' = min(K, R*W), both stages' shared memory within
  227 KB, the candidates within MAX_CANDIDATES and at least K) at every
  bucket, at `chip_smoke.py`'s decode shapes and on a hypothesis grid;
- the plan refuses what the kernel cannot run, and the launch refuses CPU
  tensors.

Tolerance: none. Scores are bit-equal and indices equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from test_torch_decode import FIXTURES, _rand_np
from tpucenterface_torch.config import DEFAULT_BUCKETS, DecodeConfig
from tpucenterface_torch.decode import fused_decode as fd
from tpucenterface_torch.decode.reference import pseudo_nms, topk_lowest_index
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _filled(b, h, w, logit, rich_rows=None, seed=0):
    hm = np.full((b, h, w, 1), logit, np.float32)
    if rich_rows is not None:
        rng = np.random.RandomState(seed)
        hm[:, rich_rows] = 3.0 * rng.randn(b, rich_rows.stop - rich_rows.start, w, 1)
    return {"hm": hm}


MAPS = {
    **{name: (make, 40) for name, make in FIXTURES.items()},
    "wh_log": (lambda: _rand_np(np.random.RandomState(3), 1, 16, 16), 8),
    "constant": (lambda: _filled(2, 20, 24, 0.7), 60),
    "underflow": (lambda: _filled(2, 20, 24, -120.0), 60),
    "rich band": (lambda: _filled(2, 40, 24, -120.0, rich_rows=slice(16, 24)), 60),
}


def _peaks(feats):
    return pseudo_nms(torch.sigmoid(torch.from_numpy(np.ascontiguousarray(feats["hm"][..., 0]))))


def _band_plans(b, h, w, k):
    """One plan of each band height `decode_plans` weighs (the block size
    does not change the selection), and the planner's."""
    plans = {plan.rows: plan for plan in fd.decode_plans(b, h, w, k)}
    return [fd.plan_decode(b, h, w, k), *plans.values()]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from([0.0, 1e-45, 2.5e-38, 0.25, 0.5, 0.5000001, 0.9, 1.0]), min_size=1, max_size=300))
def test_key_order_is_a_stable_descending_sort(values):
    v = torch.tensor(values, dtype=torch.float32)
    idx = torch.arange(len(values))
    keys = fd.peak_keys(v, idx)
    assert (keys > 0).all() and len(set(keys.tolist())) == len(values)
    want = torch.sort(v, descending=True, stable=True).indices
    assert torch.equal(torch.argsort(keys, descending=True), want)


@pytest.mark.parametrize("k_rule", ["fixture", "one", "all"])
@pytest.mark.parametrize("name", sorted(MAPS))
def test_select_banded_equals_topk(name, k_rule):
    """Every band height: the two-stage selection gives the plain version's
    top K, values bit-equal and indices equal, and lax.top_k's indices."""
    make, k_fixture = MAPS[name]
    peaks = _peaks(make())
    b, h, w = peaks.shape
    k = {"fixture": min(k_fixture, h * w), "one": 1, "all": h * w}[k_rule]
    want_v, want_i = topk_lowest_index(peaks.reshape(b, h * w), k)
    _, jax_i = jax.lax.top_k(jnp.asarray(peaks.reshape(b, h * w).numpy()), k)
    np.testing.assert_array_equal(want_i.numpy(), np.asarray(jax_i))
    for plan in _band_plans(b, h, w, k):
        got_v, got_i = fd.select_banded_plain(peaks, plan)
        assert torch.equal(got_i, want_i), (name, k, plan)
        assert torch.equal(got_v, want_v), (name, k, plan)


def test_underflow_map_keeps_the_lowest_index_zeros():
    """Every sigmoid is 0: the K slots are cells 0..K-1, as lax.top_k's."""
    peaks = _peaks(_filled(1, 20, 24, -120.0))
    assert (peaks == 0).all()
    for plan in _band_plans(1, 20, 24, 50):
        v, i = fd.select_banded_plain(peaks, plan)
        assert i[0].tolist() == list(range(50)) and (v == 0).all()


def _check_plan(b, h, w, k, plan):
    r = plan.rows
    assert plan.k == k and 1 <= r <= h
    band_of_row = [y // r for y in range(h)]
    assert band_of_row[-1] == plan.bands - 1 and sorted(set(band_of_row)) == list(range(plan.bands))
    assert all(band_of_row.count(i) <= r for i in range(plan.bands))
    assert plan.kb == min(k, r * w)
    assert plan.band_smem == fd.band_smem_bytes(r, w) <= fd.MAX_SMEM
    assert plan.merge_smem == fd.merge_smem_bytes(plan.candidates, k) <= fd.MAX_SMEM
    assert plan.candidates == plan.bands * plan.kb <= fd.MAX_CANDIDATES
    # the union holds at least K cells' keys, so the empty slots' key 0 is never kept
    assert sum(min(plan.kb, min(r, h - i * r) * w) for i in range(plan.bands)) >= k
    assert 64 <= plan.threads <= 1024 and plan.threads % 32 == 0


def _check_all(b, h, w, k):
    plans = list(fd.decode_plans(b, h, w, k))
    assert plans and fd.plan_decode(b, h, w, k) in plans
    for plan in plans:
        _check_plan(b, h, w, k, plan)


@pytest.mark.parametrize("k", [1, 100, 200, 1000])
@pytest.mark.parametrize("b", [1, 32, 128])  # 128: the flip program of a TTA batch of 64
@pytest.mark.parametrize("size", DEFAULT_BUCKETS)
def test_plan_covers_every_bucket(size, b, k):
    hw = size // DecodeConfig().stride
    _check_all(b, hw, hw, min(k, hw * hw))


SMOKE = [("main-path heads bs32@640", (32, 160, 160), 200)] + [
    (name, shape, k) for name, _, shape, k, _ in chip_smoke.DECODE_KERNEL_CASES
] + [("timed", shape, 200) for shape in chip_smoke.DECODE_TIMED_SHAPES]


@pytest.mark.parametrize("case", SMOKE, ids=[c[0] for c in SMOKE])
def test_plan_covers_chip_smokes_shapes(case):
    _, (b, h, w), k = case
    _check_all(b, h, w, min(k, h * w))


@settings(max_examples=150, deadline=None)
@given(st.integers(1, 512), st.integers(1, 512), st.data(), st.sampled_from([1, 32]))
def test_plan_covers_any_map(h, w, data, b):
    k = data.draw(st.integers(1, min(1000, h * w)))
    _check_all(b, h, w, k)


def test_plan_shrinks_rows_to_fit():
    """At W = 512 and K = 1000 a band of 32 rows would need 263 KB: the plan
    takes fewer rows, and enough of them to keep the candidates within
    bounds."""
    plan = fd.plan_decode(32, 512, 512, 1000)
    assert fd.band_smem_bytes(32, 512) > fd.MAX_SMEM
    assert plan.rows < 32 and plan.band_smem <= fd.MAX_SMEM and plan.candidates <= fd.MAX_CANDIDATES


@pytest.mark.parametrize(
    "args",
    [(1, 8, 8, 0), (1, 8, 8, 65), (0, 8, 8, 4), (65_536, 8, 8, 4), (1, 0, 8, 1), (1, 4, 10_000, 10),
     (1, 65_536, 32_768, 10)],
    ids=["K=0", "K>H*W", "no batch", "batch over the grid", "empty map", "a row over 227 KB", "2^31 cells"],
)
def test_plan_refuses_what_the_kernel_cannot_run(args):
    with pytest.raises(ValueError):
        fd.plan_decode(*args)


def test_launch_refuses_cpu_tensors():
    """The kernel launch takes CUDA tensors only; the wrapper's plain route is
    the only one for a CPU tensor (tests/test_torch_decode.py)."""
    feats = {k: torch.from_numpy(v) for k, v in _rand_np(np.random.RandomState(1), 1, 8, 8).items()}
    with pytest.raises(ValueError, match="cuda"):
        fd.launch_decode(feats, DecodeConfig(max_dets=4), fd.plan_decode(1, 8, 8, 4))
