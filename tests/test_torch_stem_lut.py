"""`quant.engine.apply_stem_lut` (the stem's uint8 -> int8 table applied on
the host) against the JAX package's function of the same name, byte for
byte: the threaded C++ route (`native.stem_lut_apply`) at 0 (the host's CPU
count), 1 and 3 threads, its numpy loop `apply_stem_lut_plain`, on the
stem's own table and on one that holds -127 and 127, on small, ragged and
empty batches. A failed build of the library raises: nothing falls back
to the loop, where JAX's function does."""

import shutil

import numpy as np
import pytest

import tpucenterface_torch.native as native
from tpucenterface.config import PreprocessConfig as JPre
from tpucenterface.quant.engine import apply_stem_lut as jax_apply_stem_lut
from tpucenterface.quant.engine import stem_input_lut as jax_stem_input_lut
from tpucenterface_torch.config import PreprocessConfig
from tpucenterface_torch.quant import engine as qe
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

SHAPES = [(2, 4, 4, 3), (1, 33, 17, 3), (0, 4, 4, 3)]


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the native staging kernel cannot be built here")


def _table(kind):
    if kind == "stem":
        lut = qe.stem_input_lut(PreprocessConfig(), "cpu")
        assert lut.tobytes() == np.asarray(jax_stem_input_lut(JPre())).tobytes()
        return lut
    lut = np.random.RandomState(5).randint(-127, 128, (256, 3)).astype(np.int8)
    lut[0], lut[255], lut[128] = -127, 127, (127, -127, 0)
    return lut


@pytest.mark.parametrize("kind", ["stem", "extremes"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("nthreads", [0, 1, 3])
def test_apply_stem_lut_matches_jax(kind, shape, nthreads):
    lut = _table(kind)
    imgs = np.random.RandomState(sum(shape)).randint(0, 256, shape).astype(np.uint8)
    if imgs.size:
        imgs.reshape(-1, 3)[:2] = [[0, 255, 128], [255, 0, 128]]  # every extreme of the table
    want = np.asarray(jax_apply_stem_lut(imgs, lut, nthreads=nthreads))
    got = qe.apply_stem_lut(imgs, lut, nthreads=nthreads)
    plain = qe.apply_stem_lut_plain(imgs, lut)
    assert got.dtype == plain.dtype == want.dtype == np.int8
    assert got.shape == plain.shape == want.shape == shape
    assert got.tobytes() == want.tobytes() == plain.tobytes()
    if kind == "extremes" and imgs.size:
        assert {-127, 127} <= set(got.ravel().tolist())


@pytest.mark.parametrize("nthreads", [0, 2])
def test_apply_stem_lut_takes_the_cpp_route(monkeypatch, nthreads):
    calls = []
    route = native.stem_lut_apply
    monkeypatch.setattr(native, "stem_lut_apply", lambda *a, **kw: calls.append(kw) or route(*a, **kw))
    lut = _table("stem")
    imgs = np.random.RandomState(1).randint(0, 256, (2, 5, 6, 3)).astype(np.uint8)
    assert qe.apply_stem_lut(imgs, lut, nthreads=nthreads).tobytes() == qe.apply_stem_lut_plain(imgs, lut).tobytes()
    assert calls == [{"nthreads": nthreads}]


def test_a_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "stage_ext.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    imgs = np.zeros((1, 2, 2, 3), np.uint8)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        qe.apply_stem_lut(imgs, _table("stem"))
    assert not native.stage_available()
