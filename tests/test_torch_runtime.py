"""The port's runtime helpers on the CPU: `runtime/prefetch.py`,
`runtime/profiling.py`, and the host staging kernel of
`tpucenterface_torch/native/` (the stem's uint8 -> int8 table) against the
port's numpy `apply_stem_lut_plain` and the JAX package's `apply_stem_lut`,
byte for byte."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import tpucenterface_torch.native as native
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.quant.engine import apply_stem_lut as jax_apply_stem_lut
from tpucenterface.quant.engine import stem_input_lut as jax_stem_input_lut
from tpucenterface_torch.config import PreprocessConfig
from tpucenterface_torch.quant.engine import apply_stem_lut, apply_stem_lut_plain, stem_input_lut
from tpucenterface_torch.runtime import prefetch_to_device
from tpucenterface_torch.runtime.profiling import annotate, trace
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"x": rng.rand(2, 3).astype(np.float32), "y": (rng.randint(0, 9, 4), torch.arange(3) + i)}
            for i in range(n)]


@pytest.mark.parametrize("size", [1, 2, 5])
def test_prefetch_keeps_order_and_values(size):
    src = _batches(4)
    out = list(prefetch_to_device(iter(src), size=size, device="cpu"))
    assert len(out) == len(src)
    for got, want in zip(out, src):
        assert set(got) == {"x", "y"} and isinstance(got["y"], tuple)
        assert isinstance(got["x"], torch.Tensor) and got["x"].device.type == "cpu"
        np.testing.assert_array_equal(got["x"].numpy(), want["x"])
        np.testing.assert_array_equal(got["y"][0].numpy(), want["y"][0])
        assert torch.equal(got["y"][1], want["y"][1])


def test_prefetch_refuses_what_it_cannot_do():
    with pytest.raises(TypeError, match="Sharding"):
        list(prefetch_to_device(iter(_batches(1)), device="cpu", sharding=object()))
    with pytest.raises(ValueError):
        list(prefetch_to_device(iter(_batches(1)), size=0, device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            list(prefetch_to_device(iter(_batches(1))))


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "profile"
    with trace(str(logdir)):
        with annotate("serving_launch"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "serving_launch" for e in events)


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native staging kernel cannot be built here")


def test_stem_lut_apply_matches_numpy_and_jax(gxx):
    """The C++ gather, threaded and inline, into a fresh array and into a
    slice of a launch buffer, and the port's `apply_stem_lut` (that C++
    route) equal the port's numpy loop and the JAX package's
    `apply_stem_lut` on the same table, byte for byte; the port's table
    equals the JAX package's."""
    lut = stem_input_lut(PreprocessConfig(), "cpu")
    assert lut.tobytes() == np.asarray(jax_stem_input_lut(JPre())).tobytes()
    rng = np.random.RandomState(3)
    imgs = rng.randint(0, 256, (3, 130, 97, 3)).astype(np.uint8)  # above the 64k-pixel inline cut
    want = apply_stem_lut_plain(imgs, lut)
    assert want.tobytes() == np.asarray(jax_apply_stem_lut(imgs, lut)).tobytes()
    assert apply_stem_lut(imgs, lut).tobytes() == want.tobytes()
    for nthreads in (0, 1, 3):
        assert native.stem_lut_apply(imgs, lut, nthreads=nthreads).tobytes() == want.tobytes()
    buf = np.full((5, 130, 97, 3), 7, np.int8)
    assert native.stem_lut_apply(imgs, lut, out=buf[1:4]) is not None
    assert buf[1:4].tobytes() == want.tobytes() and (buf[0] == 7).all() and (buf[4] == 7).all()
    ramp = np.arange(256, dtype=np.uint8)[:, None].repeat(3, 1)
    assert np.array_equal(native.stem_lut_apply(ramp, lut), lut)
    assert native.stem_lut_apply(imgs[:0], lut).shape == (0, 130, 97, 3)
    with pytest.raises(ValueError):
        native.stem_lut_apply(imgs.astype(np.int16), lut)
    with pytest.raises(ValueError):
        native.stem_lut_apply(imgs, lut[:255])
    with pytest.raises(ValueError):
        native.stem_lut_apply(imgs, lut, out=np.empty((3, 130, 97, 3), np.uint8))


def test_stage_library_is_per_host_and_a_failed_build_raises(gxx, tmp_path, monkeypatch):
    """The library's name hashes the source, flags, compiler and host, so one
    built on another machine is never loaded; a build that fails raises
    (nothing falls back to the numpy loop)."""
    here = native.library_path()
    monkeypatch.setattr(native.platform, "node", lambda: "another-host")
    assert native.library_path() != here
    bad = tmp_path / "stage_ext.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.stem_lut_apply(np.zeros((1, 3), np.uint8), np.zeros((256, 3), np.int8))
    assert not any((tmp_path / "build").glob("*.so"))
