"""The yardstick of each configuration held to readings recorded before its
architecture's code moved behind the configuration's `architecture` key
(`architectures_golden.json`, on the CPU): the variables a seed gives, the
operations of a forward at every bucket, the stride-1 blocks' work at bs32
@ 640 and the reference's head maps on two painted 128 x 128 frames. A
change to the yardstick fails here. And every architecture's files refuse a
key they do not implement.

The drawn leaves are compared bit for bit; the heads' out convs, fitted on
the reference's maps, and the maps themselves to 1e-4: torch's CPU
convolutions round differently with the number of threads."""

import hashlib
import json

import numpy as np
import pytest
import torch

from perfbench import frames, registry, work
from perfbench.reference.detect import letterbox, normalise
from perfbench.reference.model import float32_exact, get, to_device
from perfbench.tests.pb_helpers import ROOT, cpu
from perfbench.weights import make_variables

GOLDEN = json.loads((ROOT / "perfbench" / "tests" / "architectures_golden.json").read_text())
CONFIGS = ["centerface-mbv2", "mbv2x1.4-fpn48"]
SEEDS = [2**31 + 26, 7]
ARCHITECTURES = sorted(p.stem for p in (ROOT / "perfbench" / "programs").glob("*.py") if p.stem != "__init__")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


def spread_sample(a, n=64):
    a = np.asarray(a, np.float64).reshape(-1)
    return a[np.linspace(0, a.size - 1, min(n, a.size)).round().astype(int)]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CONFIGS)
def test_variables_are_the_recorded(name, seed):
    cfg = config(name)
    v = make_variables(cfg, seed, cpu())
    want = GOLDEN["variables"][f"{name}@{seed}"]
    h = hashlib.sha256()
    fitted = {}
    for path, shape, _ in registry.reference(cfg).leaf_shapes(cfg):
        a = np.ascontiguousarray(get(v, path), np.float32)
        assert a.shape == tuple(shape)
        if path[1] == "heads" and path[3] == "out":
            fitted["/".join(path)] = a.reshape(-1)
        else:
            h.update("/".join(path).encode())
            h.update(a.tobytes())
    assert h.hexdigest() == want["drawn_sha256"]
    assert sorted(fitted) == sorted(want["fitted"])
    for k, a in fitted.items():
        np.testing.assert_allclose(a, want["fitted"][k], rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("name", CONFIGS)
def test_work_is_the_recorded(name):
    cfg = config(name)
    assert {str(s): work.forward_flops(cfg, s) for s in cfg["buckets"]} == GOLDEN["forward_flops"][name]
    assert [list(b) for b in work.stride1_blocks(cfg, 640, 640, 32)] == GOLDEN["stride1_blocks"][name]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_maps_are_the_recorded(name):
    cfg = config(name)
    v = make_variables(cfg, SEEDS[0], cpu())
    imgs = frames.paint([(128, 128)] * 2, [3, 5], torch.Generator().manual_seed(SEEDS[1]))
    x = torch.stack([letterbox(torch.from_numpy(f), 128)[0] for f in imgs])
    with torch.no_grad(), float32_exact():
        maps = registry.reference(cfg).Network(cfg, to_device(v, "cpu"))(
            normalise(x, cfg["preprocess"]["mean"], cfg["preprocess"]["std"]))
    want = GOLDEN["maps"][name]
    assert sorted(maps) == sorted(want)
    for k, m in maps.items():
        w = want[k]
        assert list(m.shape) == w["shape"]
        np.testing.assert_allclose(spread_sample(m), w["sample"], rtol=1e-4, atol=1e-4, err_msg=k)
        got = [float(m.double().sum()), float((m.double() ** 2).sum())]
        np.testing.assert_allclose(got, [w["sum"], w["sumsq"]], rtol=1e-5, atol=1e-2, err_msg=k)


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_each_architecture_refuses_a_key_it_does_not_implement(arch):
    """Its reference's `check_config` and its program's `build`, before
    anything is built; a key inside a group too."""
    cfg = next(config(c["name"]) for c in BENCH["configs"] if config(c["name"])["architecture"] == arch)
    ref, prog = registry.architecture(cfg)
    for bad in ({**cfg, "squeeze_excite": True}, {**cfg, "program": {**cfg["program"], "graphs": True}}):
        with pytest.raises(ValueError, match="squeeze_excite|graphs"):
            prog.build(bad, None, cpu())
    with pytest.raises(ValueError, match="squeeze_excite"):
        ref.check_config({**cfg, "squeeze_excite": True})
