"""The port's sigmoid + pseudo-NMS against the JAX package's Pallas kernel.

`sigmoid_pseudo_nms_plain` (which the CUDA kernel must equal bit for bit on
the card) against `sigmoid_pseudo_nms_pallas(..., interpret=True)`, as
tests/test_pallas_nms.py runs it. The peak mask must be the same; the values
may differ in the last place, because JAX's and PyTorch's CPU sigmoids are
different implementations of the same function (bound 1e-6; on the seeded
maps below they agree to the bit). A peak decided by such a last-place
difference could flip between the two; these maps have none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucenterface.decode.pallas_nms import sigmoid_pseudo_nms_pallas
from tpucenterface_torch.config import DecodeConfig
from tpucenterface_torch.decode.fused_nms import (
    NMS_TILE,
    nms_grid,
    sigmoid_pseudo_nms_fused,
    sigmoid_pseudo_nms_plain,
    sigmoid_pseudo_nms_tiled,
)
from tpucenterface_torch.decode.reference import decode_feats_with_idx, pseudo_nms


@pytest.mark.parametrize("shape,seed", [((3, 32, 64), 0), ((2, 33, 17), 1), ((1, 8, 128), 2)])
def test_plain_matches_pallas_interpret(shape, seed):
    hm = (np.random.RandomState(seed).randn(*shape) * 3).astype(np.float32)
    want = np.asarray(sigmoid_pseudo_nms_pallas(jnp.asarray(hm), interpret=True))
    got = sigmoid_pseudo_nms_plain(torch.from_numpy(hm)).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert 0 < (got > 0).mean() < 0.2


def test_plateau_keeps_every_tied_cell():
    hm = torch.zeros(1, 16, 16)
    assert (sigmoid_pseudo_nms_plain(hm) == 0.5).all()
    want = np.asarray(sigmoid_pseudo_nms_pallas(jnp.zeros((1, 16, 16), jnp.float32), interpret=True))
    assert (want == 0.5).all()
    # a plateau inside a lower map: every cell of it stays, its rim goes
    hm = torch.full((1, 9, 9), -2.0)
    hm[0, 3:6, 2:7] = 1.0
    out = sigmoid_pseudo_nms_plain(hm)
    assert (out[0, 3:6, 2:7] == torch.sigmoid(torch.tensor(1.0))).all()
    assert (out[0, 2, 1:8] == 0).all() and (out[0, 6, 1:8] == 0).all()


def test_wrapper_on_cpu_is_the_plain_version():
    hm = torch.from_numpy((np.random.RandomState(3).randn(2, 12, 20, 5) * 3).astype(np.float32))
    before = sigmoid_pseudo_nms_fused.launches
    got = sigmoid_pseudo_nms_fused(hm[..., 0])        # a strided channel slice
    assert torch.equal(got, pseudo_nms(torch.sigmoid(hm[..., 0])))
    assert sigmoid_pseudo_nms_fused.launches == before
    with pytest.raises(ValueError, match="must be"):
        sigmoid_pseudo_nms_fused(hm)
    with pytest.raises(TypeError, match="float32"):
        sigmoid_pseudo_nms_fused(hm[..., 0].double())


@pytest.mark.parametrize("fast_topk", [True, False])
def test_decode_takes_the_peak_map_it_is_handed(fast_topk):
    rng = np.random.RandomState(4)
    feats = {
        "hm": torch.from_numpy((rng.randn(2, 16, 24, 1) * 3).astype(np.float32)),
        "wh": torch.from_numpy(rng.rand(2, 16, 24, 2).astype(np.float32) * 5),
        "off": torch.from_numpy(rng.rand(2, 16, 24, 2).astype(np.float32) - 0.5),
    }
    cfg = DecodeConfig(max_dets=50, fast_topk=fast_topk)
    want = decode_feats_with_idx(feats, cfg)
    got = decode_feats_with_idx(feats, cfg, peaks=sigmoid_pseudo_nms_fused(feats["hm"][..., 0]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the map handed in is the one used: an emptied map gives zero scores
    _, scores, _ = decode_feats_with_idx(feats, cfg, peaks=torch.zeros(2, 16, 24))
    assert (scores == 0).all()
    with pytest.raises(ValueError, match="peaks must be"):
        decode_feats_with_idx(feats, cfg, peaks=torch.zeros(2, 24, 16))


# ---- the kernel's tiling (csrc/nms.cu: NMS_TILE cells a thread block, each
# with a one-cell halo), modelled by sigmoid_pseudo_nms_tiled ----


@pytest.mark.parametrize("shape", [(2, 16, 32), (2, 17, 33), (3, 15, 31), (2, 33, 65), (1, 48, 96), (1, 1, 1),
                                   (2, 1, 70), (2, 70, 1), (4, 40, 40), (2, 32, 32), (2, 31, 33), (1, 65, 97)])
def test_tiled_helper_equals_the_plain_version_at_tile_seams(shape):
    hm = torch.from_numpy((np.random.RandomState(sum(shape)).randn(*shape) * 3).astype(np.float32))
    assert torch.equal(sigmoid_pseudo_nms_tiled(hm), sigmoid_pseudo_nms_plain(hm))


def test_tiled_helper_keeps_plateaus_across_tile_seams():
    """chip_smoke.py's seam case: equal blocks over a row seam and a column
    seam of the tiles, and a peak on the corner of four tiles."""
    th, tw = NMS_TILE
    hm = torch.full((2, 3 * th, 3 * tw), -1.0)
    hm[0, th - 2 : th + 3, tw - 2 : tw + 3] = 2.0
    hm[1, th - 1 : th + 1, tw - 1 : tw + 1] = 2.0
    hm[1, 2 * th, 2 * tw] = 3.0
    got = sigmoid_pseudo_nms_tiled(hm)
    assert torch.equal(got, sigmoid_pseudo_nms_plain(hm))
    assert (got[0, th - 2 : th + 3, tw - 2 : tw + 3] == torch.sigmoid(torch.tensor(2.0))).all()
    assert (got[1, th - 1 : th + 1, tw - 1 : tw + 1] > 0).all() and got[1, 2 * th, 2 * tw] > 0
    # their rims go, whatever tile they fall in
    assert not got[0, th - 3, tw - 3 : tw + 4].any() and not got[0, th + 3, tw - 3 : tw + 4].any()
    assert not got[0, th - 3 : th + 4, tw - 3].any() and not got[0, th - 3 : th + 4, tw + 3].any()
    assert got[1, 2 * th - 1 : 2 * th + 2, 2 * tw - 1 : 2 * tw + 2].count_nonzero() == 1
    # a constant map: every cell of every tile is a peak
    flat = torch.zeros(2, 40, 70)
    assert (sigmoid_pseudo_nms_tiled(flat) == 0.5).all()


@pytest.mark.parametrize("tile", [(16, 32), (8, 8), (5, 7)])
def test_tiled_helper_matches_the_pallas_kernel(tile):
    hm = (np.random.RandomState(5).randn(2, 33, 65) * 3).astype(np.float32)
    want = np.asarray(sigmoid_pseudo_nms_pallas(jnp.asarray(hm), interpret=True))
    got = sigmoid_pseudo_nms_tiled(torch.from_numpy(hm), tile).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_grid_covers_the_map():
    th, tw = NMS_TILE
    assert nms_grid(th, tw) == (1, 1) and nms_grid(th + 1, tw + 1) == (2, 2) and nms_grid(1, 1) == (1, 1)
    assert nms_grid(160, 160) == (-(-160 // th), -(-160 // tw))
    for h, w in ((80, 80), (256, 256), (33, 65)):
        gy, gx = nms_grid(h, w)
        assert (gy - 1) * th < h <= gy * th and (gx - 1) * tw < w <= gx * tw
