"""The port's preprocess against the JAX package's.

`pad_to_bucket` is exact. The matmul letterbox (`letterbox_normalize_batch`,
`letterbox_normalize`) and `normalize_images`, in the normalized and the
stem-baked raw mode, on the same uint8 images. Tolerances:
- letterbox scale and pads: equal (both take IEEE float32 quotients);
- float32 resize: atol 2e-6 on normalized values (magnitude <= ~2.2) and
  1e-4 on raw values (magnitude <= ~150): the bilinear sums run in another
  order, a few float32 ulps (measured 4.8e-7 and 3.1e-5);
- bfloat16 resize: the products of bfloat16 weights and uint8 pixels are
  exact in float32 and each output sums two taps, so both sides round the
  same float32 value: at most one bfloat16 ulp (relative 2^-8) apart on at
  most 0.1% of values (measured: equal);
- normalize_images: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucenterface import preprocess as jp
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface_torch import preprocess as tp
from tpucenterface_torch.config import PreprocessConfig
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

SIZE = 160


def _images(seed=0, b=3, hp=256, wp=384):
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, size=(b, hp, wp, 3)).astype(np.uint8)
    hws = np.array([[hp, wp], [200, 301], [131, wp]][:b], np.int32)
    for i, (h, w) in enumerate(hws):  # zero outside the content, as pad_to_bucket leaves it
        imgs[i, h:] = 0
        imgs[i, :, w:] = 0
    return imgs, hws


@pytest.mark.parametrize("shape", [(250, 333), (128, 128), (1, 129), (640, 640), (123, 457)])
def test_pad_to_bucket_exact(shape):
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, size=shape + (3,)).astype(np.uint8)
    got = tp.pad_to_bucket(img)
    ref = jp.pad_to_bucket(img)
    assert got.shape == ref.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, ref)


def _both(dtype, raw, center=True, bgr=True, seed=0):
    imgs, hws = _images(seed)
    kw = dict(resize_dtype=dtype, center=center, bgr_input=bgr)
    jx, js, jpad = jp.letterbox_normalize_batch(
        jnp.asarray(imgs), jnp.asarray(hws), SIZE, JPre(**kw), raw=raw
    )
    tx, ts, tpad = tp.letterbox_normalize_batch(
        torch.from_numpy(imgs), torch.from_numpy(hws), SIZE, PreprocessConfig(**kw), raw=raw
    )
    assert tx.shape == (3, SIZE, SIZE, 3) and tx.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    return tx.float().numpy(), np.asarray(jx, np.float32)


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("center,bgr", [(True, True), (False, False)])
def test_letterbox_f32_tight(raw, center, bgr):
    got, ref = _both("float32", raw, center, bgr)
    np.testing.assert_allclose(got, ref, atol=1e-4 if raw else 2e-6, rtol=0)


@pytest.mark.parametrize("raw", [False, True])
def test_letterbox_bf16(raw):
    got, ref = _both("bfloat16", raw, seed=1)
    np.testing.assert_allclose(got, ref, rtol=2.0 ** -8, atol=0)
    assert (got != ref).mean() <= 1e-3


def test_letterbox_single_matches_batch_row():
    imgs, hws = _images(2)
    cfg = PreprocessConfig(resize_dtype="float32")
    x, s, pad = tp.letterbox_normalize(
        torch.from_numpy(imgs[1]), torch.from_numpy(hws[1]), SIZE, cfg, raw=True
    )
    jx, js, jpad = jp.letterbox_normalize(
        jnp.asarray(imgs[1]), jnp.asarray(hws[1]), SIZE, JPre(resize_dtype="float32"), raw=True
    )
    assert x.shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-4, rtol=0)
    assert float(s) == float(js)
    np.testing.assert_array_equal(pad.numpy(), np.asarray(jpad))


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_normalize_images_equal(raw, dtype):
    imgs, _ = _images(3, b=2, hp=SIZE, wp=SIZE)
    got = tp.normalize_images(torch.from_numpy(imgs), PreprocessConfig(resize_dtype=dtype), raw=raw)
    ref = jp.normalize_images(jnp.asarray(imgs), JPre(resize_dtype=dtype), raw=raw)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_scale_and_translate_not_ported():
    imgs, hws = _images(4, b=1)
    cfg = PreprocessConfig(resize_impl="scale_translate")
    with pytest.raises(NotImplementedError):
        tp.letterbox_normalize_batch(torch.from_numpy(imgs), torch.from_numpy(hws), SIZE, cfg)
    with pytest.raises(NotImplementedError):
        tp.letterbox_normalize(torch.from_numpy(imgs[0]), torch.from_numpy(hws[0]), SIZE, cfg)
