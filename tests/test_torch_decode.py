"""The port's decode against the JAX package's.

- `decode/reference.py`: the port's reference decode against JAX
  `decode_feats_with_idx`, under both top-K rules, with a plateau fixture that
  pins the order of exactly tied scores; landmarks and the inverse letterbox.
- `decode/fused_decode.py`: the plain version of the fused decode kernel
  against `decode_feats_pallas(..., interpret=True)` (run as
  tests/test_pallas_decode.py runs it) on its random, sparse-peak and wh_log
  fixtures, comparing all K entries.

Tolerances: indices equal; scores atol 1e-6 and boxes atol 1e-4 (the
kernel's contract, tests/test_pallas_decode.py). Both sides compute the
sigmoid and the box arithmetic in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucenterface.config import DecodeConfig as JDecode
from tpucenterface.decode import reference as jref
from tpucenterface.decode.pallas_decode import decode_feats_pallas
from tpucenterface_torch.config import DecodeConfig
from tpucenterface_torch.decode import reference as tref
from tpucenterface_torch.decode.fused_decode import (
    decode_feats_fused,
    decode_feats_fused_plain,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

SCORE_ATOL = 1e-6
BOX_ATOL = 1e-4


def _rand_np(rng, b, h, w, peaky=True, lm=False):
    """tests/test_pallas_decode.py's random fixture, as numpy arrays."""
    out = {
        "hm": rng.randn(b, h, w, 1).astype(np.float32) * (3.0 if peaky else 0.3),
        "wh": (rng.rand(b, h, w, 2) * 6).astype(np.float32),
        "off": rng.rand(b, h, w, 2).astype(np.float32) - 0.5,
    }
    if lm:
        out["lm"] = rng.randn(b, h, w, 10).astype(np.float32)
    return out


def _sparse_np():
    """tests/test_pallas_decode.py's sparse-peak fixture: three real peaks on
    a flat -8 plateau, so every later K slot is a tie broken by index."""
    b, h, w = 1, 20, 20
    hm = np.full((b, h, w, 1), -8.0, np.float32)
    for (y, x, v) in [(3, 4, 4.0), (10, 15, 3.0), (17, 2, 2.0)]:
        hm[0, y, x, 0] = v
    rng = np.random.RandomState(2)
    return {
        "hm": hm,
        "wh": (rng.rand(b, h, w, 2) * 4).astype(np.float32),
        "off": rng.rand(b, h, w, 2).astype(np.float32) - 0.5,
    }


def _plateau_np(b=2, h=16, w=24):
    """Quantized logits: few distinct values, so many cells tie exactly and
    plateaus of equal neighbours are all kept as peaks. Chunks of 8 cells
    hold several tied maxima, which pins topk_2stage's chunk-rank order.
    Some wh values are negative, to exercise the >= 0 clamp."""
    rng = np.random.RandomState(9)
    hm = rng.randint(-2, 3, size=(b, h, w, 1)).astype(np.float32)
    hm[:, 4:7, 8:12] = 3.0  # a 3x4 plateau at the top score
    return {
        "hm": hm,
        "wh": (rng.rand(b, h, w, 2) * 6 - 1).astype(np.float32),
        "off": rng.rand(b, h, w, 2).astype(np.float32) - 0.5,
    }


def _fused_np(feats):
    """Fused-head form: hm/wh/off as views of one (B, H, W, 5) map, plus the
    contiguous wh+off view `whoff`."""
    y = np.concatenate([feats["hm"], feats["wh"], feats["off"]], axis=-1)
    return {"hm": y[..., 0:1], "wh": y[..., 1:3], "off": y[..., 3:5], "whoff": y[..., 1:5]}


def _fused_torch(feats):
    """The same, as views of one torch tensor (as the port's fused heads
    return them: strided slices, no copies)."""
    y = torch.from_numpy(np.concatenate([feats["hm"], feats["wh"], feats["off"]], axis=-1))
    return {"hm": y[..., 0:1], "wh": y[..., 1:3], "off": y[..., 3:5], "whoff": y[..., 1:5]}


def _jax(feats):
    return {k: jnp.asarray(v) for k, v in feats.items()}


def _torch(feats):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in feats.items()}


FIXTURES = {
    "random": lambda: _rand_np(np.random.RandomState(0), 2, 24, 32),
    "flat": lambda: _rand_np(np.random.RandomState(1), 1, 16, 16, peaky=False),
    "sparse": _sparse_np,
    "plateau": _plateau_np,
}


# --------------------------------------------------------------------------- #
# decode/reference.py
# --------------------------------------------------------------------------- #


def test_pseudo_nms_matches_jax_and_keeps_plateaus():
    feats = _plateau_np()
    s = jax.nn.sigmoid(jnp.asarray(feats["hm"][..., 0]))
    ref = np.asarray(jref.pseudo_nms(s))
    got = tref.pseudo_nms(torch.from_numpy(np.array(s))).numpy()
    np.testing.assert_array_equal(got, ref)
    # the whole top plateau survives, -inf borders keep edge cells eligible
    assert (got[:, 4:7, 8:12] > 0).all()


@pytest.mark.parametrize("fast_topk", [False, True])
@pytest.mark.parametrize("name", sorted(FIXTURES))
@pytest.mark.parametrize("fused", [False, True])
def test_reference_decode_matches_jax(name, fast_topk, fused):
    """decode_feats_with_idx: equal indices (tie order included) under both
    top-K rules, scores within 1e-6, boxes within 1e-4."""
    feats = FIXTURES[name]()
    k = 40
    jf = _jax(_fused_np(feats) if fused else feats)
    tf = _fused_torch(feats) if fused else _torch(feats)
    jb, js, ji = jref.decode_feats_with_idx(jf, JDecode(max_dets=k, fast_topk=fast_topk))
    tb, ts, ti = tref.decode_feats_with_idx(tf, DecodeConfig(max_dets=k, fast_topk=fast_topk))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BOX_ATOL, rtol=0)


@pytest.mark.parametrize("k", [1, 7, 24, 64])
def test_topk_2stage_chunk_rank_ties(k):
    """Exactly tied values: the port's two-stage top-K returns the JAX
    package's indices, whose tie order is chunk rank, not flat index."""
    rng = np.random.RandomState(k)
    flat = rng.randint(0, 4, size=(3, 512)).astype(np.float32)
    jv, ji = jref.topk_2stage(jnp.asarray(flat), k)
    tv, ti = tref.topk_2stage(torch.from_numpy(flat), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    lv, li = jax.lax.top_k(jnp.asarray(flat), k)
    tv, ti = tref.topk_lowest_index(torch.from_numpy(flat), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(li))


def test_k_clamped_to_map_size():
    feats = _rand_np(np.random.RandomState(4), 1, 4, 5)
    jb, js, ji = jref.decode_feats_with_idx(_jax(feats), JDecode(max_dets=200))
    tb, ts, ti = tref.decode_feats_with_idx(_torch(feats), DecodeConfig(max_dets=200))
    assert ti.shape == (1, 20)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    pb, ps, pi = decode_feats_fused_plain(_torch(feats), DecodeConfig(max_dets=200))
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pb.numpy(), np.asarray(jb), atol=BOX_ATOL, rtol=0)


def test_landmarks_and_inverse_letterbox_match_jax():
    feats = _rand_np(np.random.RandomState(5), 3, 16, 20, lm=True)
    cfg_j, cfg_t = JDecode(max_dets=30), DecodeConfig(max_dets=30)
    jb, js, ji = jref.decode_feats_with_idx(_jax(feats), cfg_j)
    tb, ts, ti = tref.decode_feats_with_idx(_torch(feats), cfg_t)
    jl = jref.decode_landmarks(_jax(feats), ji, cfg_j)
    tl = tref.decode_landmarks(_torch(feats), ti, cfg_t)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=BOX_ATOL, rtol=0)

    scales = np.array([0.5, 1.0, 1.7], np.float32)
    pads = np.array([[0.0, 12.5], [0.0, 0.0], [7.25, 0.0]], np.float32)
    hws = np.array([[90, 61], [64, 80], [33, 40]], np.int32)
    jbo = jax.vmap(jref.boxes_to_original)(jb, scales, pads, hws)
    jlo = jax.vmap(jref.landmarks_to_original)(jl, scales, pads, hws)
    args = [torch.from_numpy(a) for a in (scales, pads, hws)]
    tbo = tref.boxes_to_original(tb, *args)
    tlo = tref.landmarks_to_original(tl, *args)
    np.testing.assert_allclose(tbo.numpy(), np.asarray(jbo), atol=BOX_ATOL, rtol=0)
    np.testing.assert_allclose(tlo.numpy(), np.asarray(jlo), atol=BOX_ATOL, rtol=0)


# --------------------------------------------------------------------------- #
# decode/fused_decode.py: the kernel's plain version against the Pallas kernel
# --------------------------------------------------------------------------- #


def _against_pallas(feats, cfg_kw, fused=False):
    jb, js = decode_feats_pallas(_jax(feats), JDecode(**cfg_kw), interpret=True)
    tf = _fused_torch(feats) if fused else _torch(feats)
    tb, ts, ti = decode_feats_fused_plain(tf, DecodeConfig(**cfg_kw))
    # all K entries, in order
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=SCORE_ATOL, rtol=0)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=BOX_ATOL, rtol=0)
    # and the indices the plain version reports are lax.top_k's
    _, _, gi = jref.decode_feats_with_idx(_jax(feats), JDecode(fast_topk=False, **cfg_kw))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(gi))
    return tb, ts, ti


@pytest.mark.parametrize("seed,b,h,w,k", [(0, 1, 16, 16, 10), (1, 2, 24, 32, 50)])
@pytest.mark.parametrize("fused", [False, True])
def test_plain_matches_pallas_random(seed, b, h, w, k, fused):
    _against_pallas(_rand_np(np.random.RandomState(seed), b, h, w), dict(max_dets=k), fused)


def test_plain_matches_pallas_sparse_peaks():
    """All 30 entries: the three real peaks, then the plateau cells in
    lowest-index order (the knocked-out-to--1 rule of the kernel)."""
    tb, ts, ti = _against_pallas(_sparse_np(), dict(max_dets=30))
    assert ti[0, :3].tolist() == [3 * 20 + 4, 10 * 20 + 15, 17 * 20 + 2]


def test_plain_matches_pallas_wh_log():
    _against_pallas(_rand_np(np.random.RandomState(3), 1, 16, 16), dict(max_dets=8, wh_log=True))


def test_plain_matches_pallas_plateau():
    _against_pallas(_plateau_np(), dict(max_dets=60), fused=True)


def test_wrapper_takes_plain_version_on_cpu():
    """A CPU tensor takes the plain version and launches nothing."""
    feats = _fused_torch(_rand_np(np.random.RandomState(6), 2, 12, 12))
    before = decode_feats_fused.launches
    got = decode_feats_fused(feats, DecodeConfig(max_dets=16))
    ref = decode_feats_fused_plain(feats, DecodeConfig(max_dets=16))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert decode_feats_fused.launches == before


@pytest.mark.parametrize(
    "bad,err",
    [
        (lambda f: {**f, "hm": f["hm"].double()}, TypeError),
        (lambda f: {**f, "hm": f["hm"][..., 0]}, ValueError),
        (lambda f: {"hm": f["hm"], "wh": f["wh"][:, :-1], "off": f["off"]}, ValueError),
    ],
)
def test_wrapper_rejects_bad_inputs(bad, err):
    feats = _torch(_rand_np(np.random.RandomState(7), 1, 8, 8))
    with pytest.raises(err):
        decode_feats_fused(bad(feats), DecodeConfig(max_dets=4))
