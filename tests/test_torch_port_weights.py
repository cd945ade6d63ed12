"""The port's `.pth` importer (`weights/port.py`, `weights/torch_twin.py`) and
`Detector.from_torch_pth` against the JAX package's.

- The twin's key order (the target `propose_name_map` aligns foreign
  checkpoints to) equals the JAX twin's for the default model, the landmark
  head, widths 0.5 and 1.4 and ReLU instead of ReLU6; the two twins' forwards
  are bit-equal on one state dict.
- `variables_from_torch_state` / `load_torch_pth` equal the JAX
  `flax_from_torch_state` / `load_torch_pth` leaf for leaf, exactly, on bare,
  wrapped and `module.`-prefixed checkpoints; both packages raise the same
  exceptions, with the same message, on a missing key and a wrong shape.
- `propose_name_map`'s report and `variables_from_foreign_state` equal the
  JAX ones on the cases of tests/test_parity.py: foreign-renamed,
  declarative map, truncated, and two same-shape units swapped.
- `Detector.from_torch_pth` and `reload_weights(torch_pth_path=)` equal the
  `from_safetensors` route bit for bit.
Every case runs at width 0.5, where a JAX template costs ~1 s.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpucenterface_torch as T
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.weights import port as jport
from tpucenterface.weights.torch_twin import TorchCenterFace as JTwin
from tpucenterface_torch.weights import port
from tpucenterface_torch.weights.io import save_safetensors
from tpucenterface_torch.weights.torch_twin import TorchCenterFace
from test_parity import _foreign_renamed_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(width_mult=0.5, compute_dtype="float32")
TWIN_CONFIGS = {
    "default": {},
    "landmarks": dict(with_landmarks=True),
    "w0.5": dict(width_mult=0.5),
    "w1.4": dict(width_mult=1.4, fpn_channels=48, head_conv=48),
    "relu": dict(relu6=False),
}


def _leaves(tree, prefix=""):
    for k in tree:
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(tree[k])


def assert_trees_equal(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert list(g) == list(w)
    for k in w:
        assert g[k].dtype == np.float32 and w[k].dtype == np.float32, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _twin_state(seed, **cfg):
    """A JAX twin's state dict from `seed`, running statistics randomized."""
    torch.manual_seed(seed)
    twin = JTwin(JModel(**cfg)).eval()
    with torch.no_grad():
        for m in twin.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    return twin.state_dict()


@pytest.fixture(scope="module")
def small_state():
    return _twin_state(1, **SMALL)


@pytest.fixture(scope="module")
def small_cfgs():
    return T.ModelConfig(**SMALL), JModel(**SMALL)


def test_import_leaves_jax_out():
    code = (
        "import sys; import tpucenterface_torch.weights.port, tpucenterface_torch.weights.torch_twin, "
        "tpucenterface_torch.native, tpucenterface_torch.cli, tpucenterface_torch.cli.port_weights, "
        "tpucenterface_torch.cli.serve, tpucenterface_torch.cli.demo, tpucenterface_torch.cli.eval_wider, "
        "tpucenterface_torch.cli.parity_report, tpucenterface_torch.cli.flagship_tta, "
        "tpucenterface_torch.cli.flagship_pins; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tpucenterface', 'cv2')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


# --------------------------------------------------------------------------- #
# the twin
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("name", list(TWIN_CONFIGS))
def test_twin_key_order_equals_jax(name):
    kw = TWIN_CONFIGS[name]
    got = port.twin_key_order(T.ModelConfig(**kw))
    assert got == jport.twin_key_order(JModel(**kw))
    # and the whole state dict, bookkeeping buffers included, in one order
    want = JTwin(JModel(**kw)).state_dict()
    own = TorchCenterFace(T.ModelConfig(**kw)).state_dict()
    assert [(k, tuple(v.shape)) for k, v in own.items()] == [(k, tuple(v.shape)) for k, v in want.items()]


def test_twin_key_order_draws_nothing(small_state):
    """The templates are built on the meta device: porting leaves the
    global random generator as it was."""
    torch.manual_seed(3)
    a = torch.rand(4)
    torch.manual_seed(3)
    port.twin_key_order(T.ModelConfig())
    port.variables_from_torch_state(small_state, T.ModelConfig(**SMALL))
    assert torch.equal(torch.rand(4), a)


def test_twin_forward_bit_equal_to_jax_twin(small_state, small_cfgs):
    twin = TorchCenterFace(small_cfgs[0]).eval()
    jtwin = JTwin(small_cfgs[1]).eval()
    twin.load_state_dict(small_state)
    jtwin.load_state_dict(small_state)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 3, 96, 128).astype(np.float32) * 2 - 1)
    with torch.no_grad():
        got, want = twin(x), jtwin(x)
    assert set(got) == set(want) == {"hm", "wh", "off"}
    for k in want:
        assert got[k].shape == (2, want[k].shape[1], 24, 32)
        assert torch.equal(got[k], want[k]), k


# --------------------------------------------------------------------------- #
# twin-contract checkpoints
# --------------------------------------------------------------------------- #


def _forms(sd):
    return {
        "bare": sd,
        "state_dict": {"state_dict": sd, "epoch": 3},
        "model": {"model": sd},
        "model_state_dict": {"model_state_dict": sd, "optimizer": {}},
        "module_prefix": {"module." + k: v for k, v in sd.items()},
    }


def test_load_torch_pth_equals_jax_on_every_form(small_state, small_cfgs, tmp_path):
    cfg, jcfg = small_cfgs
    want = jport.flax_from_torch_state(small_state, jcfg)
    assert_trees_equal(port.variables_from_torch_state(small_state, cfg), want)
    for name, ckpt in _forms(small_state).items():
        path = str(tmp_path / f"{name}.pth")
        torch.save(ckpt, path)
        got = port.load_torch_pth(path, cfg)
        assert_trees_equal(got, jport.load_torch_pth(path, jcfg))
        assert_trees_equal(got, want)
    # numpy values, a float64 tensor and an extra key port as the JAX package ports them
    mixed = {k: (v.double() if i % 3 == 0 else v.numpy()) for i, (k, v) in enumerate(small_state.items())}
    mixed["extra.head.weight"] = torch.zeros(3)
    assert_trees_equal(port.variables_from_torch_state(mixed, cfg), jport.flax_from_torch_state(mixed, jcfg))


@pytest.mark.parametrize("fault", ["missing", "shape"])
def test_errors_equal_jax(small_state, small_cfgs, fault):
    cfg, jcfg = small_cfgs
    sd = dict(small_state)
    key = "backbone.block_3.project.conv.weight"
    if fault == "missing":
        del sd[key]
        exc = KeyError
    else:
        sd[key] = sd[key][:-1]
        exc = ValueError
    with pytest.raises(exc) as want:
        jport.flax_from_torch_state(sd, jcfg)
    with pytest.raises(exc) as got:
        port.variables_from_torch_state(sd, cfg)
    assert str(got.value) == str(want.value)


def test_inverse_port_round_trips(small_state, small_cfgs):
    """`weights.convert.state_dict_from_variables` is the inverse port (the
    JAX package's `torch_state_from_flax`)."""
    from tpucenterface_torch.weights.convert import state_dict_from_variables

    v = port.variables_from_torch_state(small_state, small_cfgs[0])
    back = state_dict_from_variables(v)
    want = jport.torch_state_from_flax(jport.flax_from_torch_state(small_state, small_cfgs[1]))
    assert set(back) == set(want) == {k for k in small_state if not k.endswith("num_batches_tracked")}
    for k in want:
        np.testing.assert_array_equal(back[k].numpy(), want[k], err_msg=k)


# --------------------------------------------------------------------------- #
# foreign checkpoints (the cases of tests/test_parity.py)
# --------------------------------------------------------------------------- #


def _swapped(foreign):
    """`foreign` with two units of identical shape signature in swapped
    registration order (tests/test_parity.py::test_auto_map_flags_swapped_same_shape_layers)."""
    keys = list(foreign.keys())
    units = {}
    for k in keys:
        units.setdefault(k.rsplit(".", 1)[0].rsplit(".", 1)[0], []).append(k)
    names = list(units)

    def sig(u):
        return [tuple(np.asarray(foreign[k]).shape) for k in units[u] if np.asarray(foreign[k]).ndim > 0]

    a, b = next((a, b) for a, b in zip(names, names[1:]) if sig(a) == sig(b))
    order = []
    for k in keys:
        u = k.rsplit(".", 1)[0].rsplit(".", 1)[0]
        if u == a:
            order.append(units[b][len([x for x in order if x in units[b]])])
        elif u == b:
            order.append(units[a][len([x for x in order if x in units[a]])])
        else:
            order.append(k)
    return {k: foreign[k] for k in order}


@pytest.fixture(scope="module")
def foreign_cases(small_cfgs):
    twin, foreign = _foreign_renamed_state(small_cfgs[1])
    declared = {f"base_net.{k}": v for k, v in twin.state_dict().items()}
    declared["base_net.extra.num_batches_tracked"] = np.int64(7)
    return {
        "renamed": foreign,
        "declarative": declared,
        "truncated": dict(list(foreign.items())[:-6]),
        "swapped": _swapped(foreign),
    }


NAME_MAP = [(r"num_batches_tracked", None), (r"^base_net\.", "")]


def _outcome(fn):
    try:
        return "ok", fn()
    except (KeyError, ValueError) as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", ["renamed", "declarative", "truncated", "swapped"])
def test_foreign_checkpoints_equal_jax(foreign_cases, small_cfgs, case, tmp_path):
    cfg, jcfg = small_cfgs
    sd = foreign_cases[case]
    report = port.propose_name_map(sd, cfg)
    assert report == jport.propose_name_map(sd, jcfg)
    expect = {"renamed": (False, True), "declarative": (False, True), "truncated": (False, False),
              "swapped": (False, True)}[case]
    assert (report["complete"], not report["unmatched_twin"]) == expect
    runs = [dict(allow_ambiguous=False), dict(allow_ambiguous=True)]
    if case in ("declarative", "truncated"):
        runs.append(dict(name_map=NAME_MAP))
    for kw in runs:
        got = _outcome(lambda: port.variables_from_foreign_state(sd, cfg, **kw))
        want = _outcome(lambda: jport.flax_from_foreign_state(sd, jcfg, **kw))
        assert got[0] == want[0], (kw, got, want)
        if got[0] == "ok":
            assert_trees_equal(got[1], want[1])
        else:
            assert got[1] == want[1]
    assert port.apply_name_map(sd, NAME_MAP).keys() == jport.apply_name_map(sd, NAME_MAP).keys()
    if case == "renamed":  # through a file, as the CLIs load it
        path = str(tmp_path / "foreign.pth")
        torch.save(sd, path)
        assert_trees_equal(
            port.load_torch_pth(path, cfg, auto_map=True, allow_ambiguous=True),
            jport.load_torch_pth(path, jcfg, auto_map=True, allow_ambiguous=True),
        )


# --------------------------------------------------------------------------- #
# the Detector
# --------------------------------------------------------------------------- #


def test_detector_from_torch_pth_equals_safetensors_route(small_state, small_cfgs, tmp_path):
    cfg = T.DetectorConfig(model=small_cfgs[0], default_size=64)
    pth = str(tmp_path / "w.pth")
    torch.save({"state_dict": small_state}, pth)
    st = str(tmp_path / "w.safetensors")
    save_safetensors(port.variables_from_torch_state(small_state, small_cfgs[0]), st)
    imgs = np.random.RandomState(2).randint(0, 255, (2, 64, 64, 3), np.uint8)

    det = T.Detector.from_torch_pth(pth, cfg, device="cpu")
    ref = T.Detector.from_safetensors(st, cfg, device="cpu")
    want = ref.detect_batch(imgs, score_thresh=-1.0)

    def same(got):
        for a, b in zip(got, want):
            assert a.boxes.tobytes() == b.boxes.tobytes() and a.scores.tobytes() == b.scores.tobytes()

    same(det.detect_batch(imgs, score_thresh=-1.0))
    other = T.Detector(config=cfg, device="cpu", seed=4)
    v0 = other.weights_version
    other.reload_weights(torch_pth_path=pth)
    assert other.weights_version == v0 + 1
    same(other.detect_batch(imgs, score_thresh=-1.0))
    with pytest.raises(ValueError, match="variables, safetensors_path, or torch_pth_path"):
        other.reload_weights()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.Detector.from_torch_pth(pth, cfg)
