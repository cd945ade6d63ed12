"""The port's training loop, exports and CLIs (`tpucenterface_torch/train/loop.py`,
`cli/train.py`, `cli/train_flagship.py`) on the CPU.

A narrow float32 model on a tiny dataset of jpgs: the loop runs, logs only at
its boundaries, checkpoints and resumes (a restored state equals the saved
one bit for bit and steps as it would have; a resume that runs no further
steps does not save again), switches to FrozenBN at its boundary, and
exports weights that the JAX package's `load_safetensors` reads equal and on
which the port's Detector and the JAX Detector give the same detections
(float32 on both sides: scores within 1e-5, boxes within 1e-3 px, the bound
of tests/test_torch_detector.py). The two CLIs run tiny.
"""

import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from tpucenterface.config import DecodeConfig as JDecode
from tpucenterface.config import DetectorConfig as JDetectorConfig
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.detector import Detector as JDetector
from tpucenterface.train.metrics import make_logger as jmake_logger
from tpucenterface.weights.io import load_safetensors as jax_load
import tpucenterface_torch as T
from tpucenterface_torch.config import ModelConfig, TrainConfig
from tpucenterface_torch.data.wider import WiderImage
from tpucenterface_torch.train import loop
from tpucenterface_torch.train import step as pstep
from tpucenterface_torch.train.metrics import make_logger
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SETTING = ((1, 16, 1, 1), (6, 24, 1, 2), (6, 32, 1, 2), (6, 64, 1, 2), (6, 96, 1, 1), (6, 160, 1, 2))
MODEL = dict(inverted_residual_setting=SETTING, width_mult=0.5, compute_dtype="float32")


def _tcfg(**kw):
    return TrainConfig(**dict(dict(input_size=64, batch_size=4, max_objs=8, lr=1e-3), **kw))


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("wider")
    rng = np.random.RandomState(0)
    records = []
    for i in range(8):
        img = rng.randint(0, 255, (80, 100, 3), np.uint8)
        img[20:50, 30:70] = 255
        p = str(root / f"img_{i}.jpg")
        cv2.imwrite(p, img)
        records.append(WiderImage(path=p, rel_path=f"ev/img_{i}.jpg",
                                  boxes=np.array([[30, 20, 40, 30]], np.float32), invalid=np.array([False])))
    return records


def _run(records, workdir, steps, **kw):
    cfg = kw.pop("train_cfg", _tcfg())
    return loop.train(records, model_cfg=ModelConfig(**MODEL), train_cfg=cfg, workdir=str(workdir),
                      max_steps=steps, device="cpu", **kw)


def _assert_trees_equal(a, b):
    pa, pb = list(pstep.tree_paths(a)), list(pstep.tree_paths(b))
    assert [p for p, _ in pa] == [p for p, _ in pb]
    for (path, x), (_, y) in zip(pa, pb):
        x, y = (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v)) for v in (x, y))
        assert torch.equal(x, y), path


def test_train_checkpoint_resume_and_no_resave(tiny_dataset, tmp_path):
    """Three steps logged at every step and saved at steps 2 and 3; the
    latest checkpoint restores the returned state bit for bit (params,
    batch_stats, Adam's count and moments, step, EMA), and a step from it
    equals a step from the live state on the same batch; a resume at
    max_steps runs nothing and does not save again."""
    logs = {}
    tcfg = _tcfg(ema_decay=0.95)
    state = _run(tiny_dataset, tmp_path / "run", 3, train_cfg=tcfg, log_every=1, ckpt_every=2,
                 log_fn=lambda s, m: logs.update({s: m}))
    assert int(state.step) == 3 and sorted(logs) == [1, 2, 3]
    assert all(np.isfinite(m["loss"]) and m["imgs_per_sec"] > 0 for m in logs.values())
    assert sorted(d for d in os.listdir(tmp_path / "run") if d.startswith("ckpt_")) == ["ckpt_0000002",
                                                                                      "ckpt_0000003"]
    model, template, tx = pstep.make_train_state(ModelConfig(**MODEL), tcfg, device="cpu")
    restored = loop.restore_checkpoint(str(tmp_path / "run"), template)
    assert int(restored.step) == 3
    for name in ("params", "batch_stats", "opt_state", "ema_params"):
        _assert_trees_equal(getattr(restored, name), getattr(state, name))
    fn = pstep.make_train_step(model, tx, tcfg)
    batch = pstep.make_dummy_batch(4, 64, tcfg, device="cpu")
    a, _ = fn(state, batch)
    b, _ = fn(restored, batch)
    for name in ("params", "batch_stats", "opt_state", "ema_params"):
        _assert_trees_equal(getattr(a, name), getattr(b, name))
    mtime = os.path.getmtime(tmp_path / "run" / "ckpt_0000003" / loop.STATE_FILE)
    again = _run(tiny_dataset, tmp_path / "run", 3, train_cfg=tcfg, ckpt_every=2)
    assert int(again.step) == 3
    assert os.path.getmtime(tmp_path / "run" / "ckpt_0000003" / loop.STATE_FILE) == mtime
    with pytest.raises(FileExistsError):
        loop.save_checkpoint(str(tmp_path / "run"), again)
    assert loop.restore_checkpoint(str(tmp_path / "none"), template) is None
    with pytest.raises(ValueError, match="train state"):
        loop.restore_checkpoint(str(tmp_path / "run"), pstep.make_train_state(ModelConfig(**MODEL), _tcfg(),
                                                                              device="cpu")[1])


def test_freeze_bn_boundary(tiny_dataset, tmp_path):
    """train() switches to the FrozenBN step at freeze_bn_steps: the
    statistics after five steps equal those at step 2 bit for bit, while
    the params kept moving."""
    tcfg = _tcfg(freeze_bn_steps=2)
    at2 = _run(tiny_dataset, tmp_path / "a", 2, train_cfg=tcfg, ckpt_every=0, resume=False)
    at5 = _run(tiny_dataset, tmp_path / "b", 5, train_cfg=tcfg, ckpt_every=0, resume=False)
    assert int(at5.step) == 5
    _assert_trees_equal(at5.batch_stats, at2.batch_stats)
    moved = [not torch.equal(x, y) for (_, x), (_, y) in zip(pstep.tree_paths(at5.params),
                                                             pstep.tree_paths(at2.params))]
    assert any(moved)


def test_loop_has_no_per_step_host_fetch(tiny_dataset, tmp_path, monkeypatch):
    """Several steps are enqueued before any device value is read: the step
    counter lives on the host and metrics are read at log boundaries only
    (tests/test_train.py::test_train_loop_no_per_step_host_sync)."""
    events = []

    class Proxy:
        def __init__(self, v):
            self._v = v

        def __int__(self):
            events.append("fetch")
            return int(self._v)

        def __float__(self):
            events.append("fetch")
            return float(self._v)

    def fake_make(model, tx, cfg, pre_cfg=None, frozen_bn=False):
        def step(st, batch):
            import dataclasses

            events.append("step")
            return dataclasses.replace(st, step=Proxy(events.count("step"))), {"loss": Proxy(1.0)}

        return step

    monkeypatch.setattr(loop, "make_train_step", fake_make)
    monkeypatch.setattr(loop, "save_checkpoint", lambda *a, **k: "skipped")
    monkeypatch.setattr(loop, "export_weights", lambda *a, **k: "skipped")
    _run(tiny_dataset, tmp_path / "r", 4, log_every=100, ckpt_every=0, log_fn=lambda s, m: None, resume=False)
    assert events.count("step") == 4 and "fetch" not in events, events


def test_export_read_by_jax_and_detections_match(tiny_dataset, tmp_path):
    """model.safetensors and model_ema.safetensors: the JAX package's
    load_safetensors reads them equal to the state (EMA params with the
    live batch_stats), and on the live export the port's Detector and the
    JAX Detector give the same detections."""
    state = _run(tiny_dataset, tmp_path / "run", 3, train_cfg=_tcfg(ema_decay=0.9), ckpt_every=0)
    for name, params in (("model", state.params), ("model_ema", state.ema_params)):
        got = jax_load(str(tmp_path / "run" / f"{name}.safetensors"))
        _assert_trees_equal({k: {kk: np.asarray(vv) for kk, vv in pstep.tree_paths(v)} for k, v in got.items()},
                            {"params": dict(pstep.tree_paths(params)),
                             "batch_stats": dict(pstep.tree_paths(state.batch_stats))})
    path = str(tmp_path / "run" / "model.safetensors")
    port = T.Detector.from_safetensors(path, T.DetectorConfig(model=ModelConfig(**MODEL), default_size=64),
                                       device="cpu")
    ref = JDetector(variables=jax_load(path), config=JDetectorConfig(
        model=JModel(**MODEL), decode=JDecode(fast_topk=False), default_size=64))
    imgs = np.stack([cv2.imread(r.path) for r in tiny_dataset[:2]])
    for a, b in zip(port.detect_batch(imgs, score_thresh=0.0), ref.detect_batch(imgs, score_thresh=0.0)):
        np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
        np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)


def test_train_refuses_several_devices(tiny_dataset, tmp_path):
    """Two devices in one process without a process group: data-parallel
    training runs one process per device (tests/test_torch_multiprocess.py)."""
    with pytest.raises(ValueError, match="n_devices=2"):
        _run(tiny_dataset, tmp_path / "r", 1, n_devices=2)


@pytest.mark.parametrize("n_devices", [None, 1])
def test_train_without_a_card_raises(tiny_dataset, tmp_path, monkeypatch, n_devices):
    """With no device named, no process group and no card (CUDA hidden),
    `train` raises before it writes anything: nothing falls back to the
    CPU, with or without `n_devices`."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.train(tiny_dataset, model_cfg=ModelConfig(**MODEL), train_cfg=_tcfg(), workdir=str(tmp_path / "r"),
                   max_steps=1, n_devices=n_devices)
    assert not (tmp_path / "r").exists()


def test_logger_prints_as_jax(capsys):
    m = {"loss": 1.234567, "hm_loss": 0.5}
    make_logger(use_tensorboard=False)(7, m)
    jmake_logger(use_tensorboard=False)(7, m)
    port_line, jax_line = capsys.readouterr().out.splitlines()
    assert port_line == jax_line == '[step 7] {"loss": 1.2346, "hm_loss": 0.5}'


@pytest.mark.parametrize("fmt", ["bbx", "retinaface"])
def test_cli_train_tiny(tmp_path, fmt):
    """`cli.train` on a WIDER-layout tree: the official bbx_gt file, or the
    RetinaFace label.txt with --landmarks; one step at 64 on the CPU."""
    from tpucenterface_torch.cli.train import main

    images = tmp_path / "WIDER_train" / "images" / "ev"
    images.mkdir(parents=True)
    rng = np.random.RandomState(1)
    for i in range(4):
        cv2.imwrite(str(images / f"{i}.jpg"), rng.randint(0, 255, (80, 100, 3), np.uint8))
    if fmt == "bbx":
        (tmp_path / "wider_face_split").mkdir()
        (tmp_path / "wider_face_split" / "wider_face_train_bbx_gt.txt").write_text(
            "".join(f"ev/{i}.jpg\n1\n10 12 30 40 0 0 0 0 0 0\n" for i in range(4)))
        extra = []
    else:
        (tmp_path / "WIDER_train" / "label.txt").write_text("".join(
            f"# ev/{i}.jpg\n10 12 30 40 15 20 0 30 20 0 22 28 0 16 40 0 30 40 0 0.9\n" for i in range(4)))
        extra = ["--gt-format", "retinaface", "--landmarks"]
    wd = tmp_path / "run"
    main(["--wider-root", str(tmp_path), "--workdir", str(wd), "--input-size", "64", "--batch-size", "4",
          "--max-steps", "1", "--workers", "0", "--device", "cpu", *extra])
    assert {"ckpt_0000001", "model.safetensors"} <= set(os.listdir(wd))
    assert ("params/heads/lm/out/kernel" in set(T.weights.io.read_safetensors_flat(str(wd / "model.safetensors")))
            ) == (fmt == "retinaface")


def test_cli_train_flagship_tiny(tmp_path):
    """`cli.train_flagship`: synth scenes, two steps split by a stop and a
    resume, FrozenBN from step 1, EMA, then the held-out AP of both exports
    through the port's Detector in flagship_report.json."""
    import json

    from tpucenterface_torch.cli.train_flagship import main

    wd = tmp_path / "run"
    assert main(["--workdir", str(wd), "--train-images", "8", "--val-images", "4", "--steps", "2",
                 "--batch-size", "4", "--input-size", "64", "--workers", "0", "--freeze-bn", "1",
                 "--hw-min", "128", "--hw-max", "160", "--min-face", "12", "--device", "cpu"]) == 0
    report = json.load(open(wd / "flagship_report.json"))
    assert set(report["ap"]) == {"model", "model_ema"}
    for aps in report["ap"].values():
        assert set(aps) == {"easy", "medium", "hard"}
    assert {"ckpt_0000001", "ckpt_0000002"} <= set(os.listdir(wd))


def test_import_leaves_jax_and_cv2_out():
    """The training and data modules import neither jax, flax nor the JAX
    package, and none of them imports cv2 (it is imported inside the
    functions that decode, warp, draw or write)."""
    code = (
        "import sys; import tpucenterface_torch.train, tpucenterface_torch.train.losses, "
        "tpucenterface_torch.train.step, tpucenterface_torch.train.loop, tpucenterface_torch.train.metrics, "
        "tpucenterface_torch.data.targets, tpucenterface_torch.data.augment, tpucenterface_torch.data.loader, "
        "tpucenterface_torch.data.synth, tpucenterface_torch.data.wider, tpucenterface_torch.cli.train, "
        "tpucenterface_torch.cli.train_flagship, tpucenterface_torch.weights.io; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'tpucenterface', 'cv2')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0, r.stdout + r.stderr


def test_save_safetensors_read_by_the_package(tmp_path):
    """The numpy writer: float32, int32 and uint8 leaves, a 0-d step and a
    non-contiguous (transposed) kernel, tensors and arrays, read back equal
    by the `safetensors` package and by the port's reader; an unsupported
    dtype raises."""
    from safetensors.numpy import load_file

    from tpucenterface_torch.weights.io import load_safetensors, save_safetensors

    rng = np.random.RandomState(0)
    tree = {"params": {"conv": {"kernel": rng.randn(3, 3, 1, 5).astype(np.float32).transpose(3, 2, 1, 0)},
                       "bias": torch.arange(5, dtype=torch.float32)},
            "opt_state": {"count": torch.tensor(7, dtype=torch.int32)}, "image": np.ones((2, 3), np.uint8)}
    path = str(tmp_path / "x.safetensors")
    save_safetensors(tree, path)
    got = load_file(path)
    assert set(got) == {"params/conv/kernel", "params/bias", "opt_state/count", "image"}
    assert got["opt_state/count"].shape == () and got["opt_state/count"].dtype == np.int32
    np.testing.assert_array_equal(got["params/conv/kernel"], tree["params"]["conv"]["kernel"])
    _assert_trees_equal(load_safetensors(path), tree)
    with pytest.raises(ValueError, match="unsupported dtype"):
        save_safetensors({"c": np.zeros(2, np.complex64)}, path)
