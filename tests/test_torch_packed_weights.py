"""The packed deployment artifact (`weights.io.save_packed_weights` /
`load_packed_weights`) of the port against the JAX package's, on the small
float32 model of `tests/test_w4.py` at 64 px, at W4 (two grid indices a
byte) and W8 with int8_dw.

- An artifact written by either package loads in the other to the same
  scales and params (bit-equal arrays), and the Detectors that install the
  two loads serve bit-equal quant head maps (both packages' quant forwards
  run op by op on the CPU);
- the port's own round trip serves bit-equal detections (the artifact
  records the served weights' own rule, `QuantEngine.quant_weight`, so PTQ
  and AdaRound alike reload exactly), and at W4 the artifact is
  under half of the float32 params' bytes;
- the manifest names the dtypes the JAX loader expects.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import tpucenterface_torch as T
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)
from torch_ft_ref import JCFG, SIZE, np_tree, port_cfg, small_variables
from tpucenterface.config import DetectorConfig as JDetectorConfig
from tpucenterface.detector import Detector as JDetector
from tpucenterface.weights.io import load_packed_weights as j_load_packed
from tpucenterface.weights.io import save_packed_weights as j_save_packed
from tpucenterface_torch.weights.io import load_packed_weights, save_packed_weights

CONFIGS = {"w4": dict(weight_bits=4), "w8_dw": dict(int8_dw=True)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(5)
    return rng.randint(0, 255, (4, SIZE, SIZE, 3), np.uint8), rng.randint(0, 255, (2, SIZE, SIZE, 3), np.uint8)


def _jdet(seed=0):
    return JDetector(variables=small_variables(seed), config=JDetectorConfig(model=JCFG, default_size=SIZE))


def _pdet(seed=0):
    return T.Detector(variables=small_variables(seed), config=T.DetectorConfig(model=port_cfg(), default_size=SIZE), device="cpu")


def _same_load(a, b):
    (sa, pa), (sb, pb) = a, b
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]), err_msg=k)
    fa, fb = np_tree(pa), np_tree(pb)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype == np.float32, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=str(k))


def _maps(det, x):
    """The quant head maps of a quantized Detector (either package), numpy."""
    if isinstance(det, JDetector):
        out = det._quant(jnp.asarray(x))  # op by op: the engine's __call__ is not jitted
        return {k: np.asarray(out[k]) for k in ("hm", "wh", "off")}
    return {k: v.numpy() for k, v in det._quant(torch.from_numpy(x)).items() if k in ("hm", "wh", "off")}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_artifact_reads_equal_in_both_loaders(name, inputs, tmp_path):
    """The fast half of the next test: the port's artifact, read by the JAX
    loader and by the port's, gives bit-equal scales and params."""
    calib_u8, _ = inputs
    kw = CONFIGS[name]
    pdet = _pdet()
    pdet.quantize(calib_images=calib_u8, **kw)
    pp = str(tmp_path / "port.npz")
    save_packed_weights(pdet, pp)
    _same_load(load_packed_weights(pp), j_load_packed(pp))
    scales, _ = j_load_packed(pp)
    assert int(scales["cfg:weight_bits"]) == kw.get("weight_bits", 8)
    assert int(scales["cfg:int8_dw"]) == int(kw.get("int8_dw", False))


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CONFIGS))
def test_artifacts_cross_load_bit_equal(name, inputs, tmp_path):
    """Slow (~30 s for the two cases): the JAX package writes its artifact
    and serves both op by op, which compiles every op of the engine once."""
    calib_u8, _ = inputs
    kw = CONFIGS[name]
    jp, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jdet = _jdet()
    jdet.quantize(calib_images=calib_u8, **kw)
    j_save_packed(jdet, jp)
    pdet = _pdet()
    pdet.quantize(calib_images=calib_u8, **kw)
    save_packed_weights(pdet, pp)
    x = (np.random.RandomState(9).rand(1, SIZE, SIZE, 3) * 200 - 100).astype(np.float32)
    for path in (jp, pp):
        # the two loaders agree on each artifact
        _same_load(load_packed_weights(path), j_load_packed(path))
        j2, p2 = _jdet(seed=1), _pdet(seed=1)  # other float weights on purpose
        js, jq = j_load_packed(path)
        j2.quantize(scales=js, quant_params=jq)
        ps, pq = load_packed_weights(path)
        p2.quantize(scales=ps, quant_params=pq)
        assert p2._quant.weight_bits == j2._quant.weight_bits == kw.get("weight_bits", 8)
        assert p2._quant.int8_dw == j2._quant.int8_dw == kw.get("int8_dw", False)
        want, got = _maps(j2, x), _maps(p2, x)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path} {k}")


def test_port_round_trip_and_size(inputs, tmp_path):
    calib_u8, imgs = inputs
    for bits, dw, ada in ((4, False, 8), (8, True, 0)):
        det = _pdet()
        det.quantize(calib_images=calib_u8, weight_bits=bits, int8_dw=dw, adaround_steps=ada)
        want = det.detect_batch(imgs, score_thresh=-1.0)
        p = str(tmp_path / f"packed_{bits}.npz")
        sizes = save_packed_weights(det, p)
        if bits == 4:
            assert sizes["packed_bytes"] < 0.5 * sizes["f32_bytes"], sizes
        scales, qp = load_packed_weights(p)
        det2 = _pdet(seed=1)
        det2.quantize(scales=scales, quant_params=qp)
        assert det2._quant.weight_bits == bits and det2._quant.int8_dw == dw
        for a, b in zip(det2.detect_batch(imgs, score_thresh=-1.0), want):
            np.testing.assert_array_equal(a.scores, b.scores)
            np.testing.assert_array_equal(a.boxes, b.boxes)
        # the B7 route takes the loaded weights too
        if dw:
            det3 = _pdet(seed=1)
            det3.quantize(scales=scales, quant_params=qp, fused_blocks=True)
            assert det3._quant.fused_block_indices() == [4, 6]


def test_manifest_layout(inputs, tmp_path):
    calib_u8, _ = inputs
    det = _pdet()
    det.quantize(calib_images=calib_u8, weight_bits=4)
    p = str(tmp_path / "w4.npz")
    save_packed_weights(det, p)
    z = np.load(p)
    manifest = json.loads(bytes(z["manifest"]).decode())
    assert manifest["weight_bits"] == 4 and manifest["int8_dw"] == 0
    assert {info["dtype"] for info in manifest["leaves"].values()} == {"float32"}
    assert sorted(manifest["act"]) == manifest["act"] and "stem" in manifest["act"]
    for tag, info in manifest["packed"].items():
        n = int(np.prod(info["shape"]))
        assert z[f"g/{tag}"].dtype == np.uint8 and z[f"g/{tag}"].size == (n + 1) // 2
        assert z[f"s/{tag}"].dtype == np.float32 and z[f"s/{tag}"].size == info["shape"][-1]
    assert "heads.out" not in manifest["packed"] and "head.out" in manifest["packed"]
    assert not any(k.endswith(".dw") for k in manifest["packed"])  # int8_dw off: depthwise kernels ride raw


def test_packed_requires_quantized(tmp_path):
    with pytest.raises(ValueError, match="quantize"):
        save_packed_weights(_pdet(), str(tmp_path / "nope.npz"))
