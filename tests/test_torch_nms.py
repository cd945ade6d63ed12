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
    sigmoid_pseudo_nms_fused,
    sigmoid_pseudo_nms_plain,
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
