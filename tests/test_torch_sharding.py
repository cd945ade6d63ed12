"""The port's data parallelism (`runtime/sharding.py`, `ServingEngine(mesh=)`,
`prefetch_to_device(sharding=)`, `train.step.shard_train_step`) in one
process on the CPU.

The counterpart of tests/test_sharding.py and of the `mesh=` cases of
tests/test_serving.py: the JAX files' 8 fake devices become a mesh of 4
logical CPU replicas (`data_mesh(devices=["cpu"] * 4)`), and each result is
held to the single-device one and to the JAX package's DP result on its 8
fake devices. Model input 64, float32 compute, random weights from a seed;
bounds as in the JAX files: scores within 1e-5, boxes within 1e-3 px; the
int8-input engine bit for bit. A one-rank gloo process group (a free local
port) runs the collective paths: the DP train step bit-equal to the plain
step. Two processes: tests/test_torch_multiprocess.py.
"""

import contextlib
import socket

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import tpucenterface_torch as T
import tpucenterface_torch.runtime.sharding as sh
from tpucenterface.config import DecodeConfig as JDecode
from tpucenterface.config import DetectorConfig as JDetectorConfig
from tpucenterface.config import ModelConfig as JModel
from tpucenterface.detector import Detector as JDetector
from tpucenterface.runtime import sharding as jsh
from tpucenterface.runtime.serving import ServingEngine as JServingEngine
from tpucenterface_torch.config import ModelConfig, TrainConfig
from tpucenterface_torch.model.centernet import CenterFaceNet, init_model
from tpucenterface_torch.runtime.prefetch import prefetch_to_device
from tpucenterface_torch.runtime.serving import ServingEngine, ServingRouter
from tpucenterface_torch.runtime.sharding import (
    ShardedTensor,
    batch_sharding,
    data_mesh,
    put_sharded,
    replicated,
    shard_batch_fn,
)
from tpucenterface_torch.train import step as pstep
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

HW = (64, 64)
T_OUT = 120  # seconds any one future may take


def _mesh(n=4):
    return data_mesh(devices=["cpu"] * n)


def _cfg():
    return T.DetectorConfig(model=ModelConfig(compute_dtype="float32"), default_size=64)


@pytest.fixture(scope="module")
def weights():
    return init_model(_cfg().model, seed=0)[1]


@pytest.fixture
def det(weights):
    return T.Detector(variables=weights, config=_cfg(), device="cpu")


@pytest.fixture(scope="module")
def jax_det(weights):
    return JDetector(variables=weights, config=JDetectorConfig(
        model=JModel(compute_dtype="float32"), decode=JDecode(fast_topk=False), default_size=64))


def _requests(n_req, bs, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 255, (bs, *HW, 3), np.uint8) for _ in range(n_req)]


def _close(a, b):
    np.testing.assert_allclose(a.scores, b.scores, atol=1e-5)
    np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-3)


def _spy(eng):
    launches = []
    orig = eng._fn
    eng._fn = lambda b, **kw: (launches.append(b), orig(b, **kw))[1]
    return launches


# --------------------------------------------------------------------------- #
# the mesh and its puts
# --------------------------------------------------------------------------- #


def test_mesh_has_4_devices(monkeypatch):
    """A CPU mesh is asked for by its devices; the default mesh is the cards
    and raises where there are none (CUDA hidden)."""
    mesh = _mesh()
    assert mesh.size == 4 and mesh.devices == (torch.device("cpu"),) * 4
    assert (mesh.world_size, mesh.rank, mesh.axis_names) == (1, 0, ("data",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (None, 1):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data_mesh(n)
    assert data_mesh(2, devices=["cpu"] * 4).size == 2
    with pytest.raises(ValueError, match="n_devices=5"):
        data_mesh(5, devices=["cpu"] * 4)


def test_shard_batch_fn_matches_unsharded():
    mesh = _mesh()
    w = torch.from_numpy(np.random.RandomState(0).rand(16, 8).astype(np.float32))

    def fn(x):
        return torch.tanh(x @ w)

    x = torch.from_numpy(np.random.RandomState(1).rand(32, 16).astype(np.float32))
    seen = []
    sharded = shard_batch_fn(fn, mesh, program_for=lambda d: (seen.append(d), fn)[1])
    y = sharded(put_sharded(x, mesh))
    np.testing.assert_allclose(y.numpy(), fn(x).numpy(), atol=1e-6)
    assert seen == list(mesh.devices)  # one program a device of the mesh
    np.testing.assert_allclose(shard_batch_fn(fn, mesh)(x.numpy()).numpy(), fn(x).numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        sharded(x[:30])


def test_put_sharded_splits_rows_and_replicates():
    mesh = _mesh()
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    got = put_sharded({"x": x, "y": (x[:, :1],)}, mesh)
    assert isinstance(got["x"], ShardedTensor) and len(got["x"].shards) == 4
    assert [tuple(s.shape) for s in got["x"].shards] == [(2, 3)] * 4 and got["x"].shape == (8, 3)
    np.testing.assert_array_equal(got["x"].numpy(), x)
    np.testing.assert_array_equal(got["y"][0].numpy(), x[:, :1])
    rep = replicated(mesh).put(x)
    assert rep.replicated and len(rep.shards) == 4 and rep.shape == (8, 3)
    np.testing.assert_array_equal(rep.numpy(), x)


def test_dp_detector_inference_matches_single(det, jax_det):
    """The batch program over the 4 replicas against the same program on
    the whole batch, and against the JAX DP program on 8 fake devices."""
    mesh = _mesh()
    b, s = 8, 64
    imgs = np.random.RandomState(0).randint(0, 255, (b, s, s, 3), np.uint8)
    hws = np.tile(np.array([[s, s]], np.int32), (b, 1))
    single = det._batch_fn(b, (s, s), s)
    boxes1, scores1 = single(torch.from_numpy(imgs), torch.from_numpy(hws))
    dp = shard_batch_fn(lambda im, hw: single(im, hw), mesh, num_batch_args=2)
    boxes2, scores2 = dp(put_sharded(imgs, mesh), put_sharded(hws, mesh))
    np.testing.assert_allclose(scores2.numpy(), scores1.numpy(), atol=1e-5)
    np.testing.assert_allclose(boxes2.numpy(), boxes1.numpy(), atol=1e-3)
    jmesh = jsh.data_mesh()
    jfn = jsh.shard_batch_fn(jax_det._batch_fn(b, (s, s), s), jmesh, num_batch_args=2)
    jboxes, jscores = jfn(jsh.put_sharded(jnp.asarray(imgs), jmesh), jsh.put_sharded(jnp.asarray(hws), jmesh))
    np.testing.assert_allclose(scores2.numpy(), np.asarray(jscores), atol=1e-5)
    np.testing.assert_allclose(boxes2.numpy(), np.asarray(jboxes), atol=1e-3)


def test_prefetch_preserves_order_and_device():
    mesh = _mesh()
    batches = [{"x": np.full((8, 4), i, np.float32)} for i in range(5)]
    out = list(prefetch_to_device(iter(batches), size=2, sharding=batch_sharding(mesh)))
    assert len(out) == 5
    for i, b in enumerate(out):
        assert isinstance(b["x"], ShardedTensor) and b["x"].devices == mesh.devices
        assert float(b["x"].shards[0][0, 0]) == i and b["x"].shape == (8, 4)


def test_maybe_init_distributed_noop_single_process(monkeypatch):
    """Without a coordinator the init is a no-op; with one the group is
    joined over TCP (NCCL, or gloo when asked for), from the arguments or
    the TPUCF_* variables, `TPUCF_MULTIHOST=1` through env://; idempotent."""
    for k in ("TPUCF_COORDINATOR", "TPUCF_MULTIHOST", "TPUCF_NUM_PROCS", "TPUCF_PROC_ID"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(sh, "_DISTRIBUTED_INITIALIZED", False)
    assert sh.maybe_init_distributed() is False
    calls = []
    monkeypatch.setattr(sh.dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    # NCCL unless the caller names gloo: with no card a group is refused,
    # never moved onto the CPU unasked
    monkeypatch.setattr(sh.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        sh.maybe_init_distributed(coordinator_address="10.0.0.1:1234", num_processes=4, process_id=1)
    assert calls == []
    assert sh.maybe_init_distributed(coordinator_address="10.0.0.1:1234", num_processes=4, process_id=1,
                                     backend="gloo")
    assert calls == [(("gloo",), {"init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 1})]
    assert sh.maybe_init_distributed() is True  # idempotent
    monkeypatch.setattr(sh, "_DISTRIBUTED_INITIALIZED", False)
    monkeypatch.setenv("TPUCF_COORDINATOR", "10.0.0.2:99")
    monkeypatch.setenv("TPUCF_NUM_PROCS", "2")
    monkeypatch.setenv("TPUCF_PROC_ID", "0")
    assert sh.maybe_init_distributed(backend="gloo")
    assert calls[-1] == (("gloo",), {"init_method": "tcp://10.0.0.2:99", "world_size": 2, "rank": 0})
    monkeypatch.setattr(sh, "_DISTRIBUTED_INITIALIZED", False)
    monkeypatch.delenv("TPUCF_COORDINATOR")
    monkeypatch.setenv("TPUCF_MULTIHOST", "1")
    assert sh.maybe_init_distributed(backend="gloo")
    assert calls[-1] == (("gloo",), {"init_method": "env://"})
    monkeypatch.setattr(sh, "_DISTRIBUTED_INITIALIZED", False)


def test_process_local_batch_bounds_single():
    assert sh.process_local_batch_bounds(32) == (0, 32) == jsh.process_local_batch_bounds(32)
    assert [sh._bounds(10, 3, i) for i in range(3)] == [(0, 3), (3, 6), (6, 10)]


# --------------------------------------------------------------------------- #
# ServingEngine(mesh=)
# --------------------------------------------------------------------------- #


def test_dp_serving_matches_single_device(det):
    reqs = _requests(4, 4, seed=21)  # 16 images, device_batch 8 over 4 replicas
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0, mesh=_mesh()) as eng:
        futs = [eng.submit(r) for r in reqs]
        dp = [f.result(timeout=T_OUT) for f in futs]
        assert eng.stats()["pinned_launches"] == 0  # DP launches stage plainly
    for imgs, dets in zip(reqs, dp):
        for a, b in zip(dets, det.detect_batch(imgs, score_thresh=-1.0)):
            _close(a, b)


def test_dp_serving_oversize_rounds_to_mesh(det):
    mesh = _mesh()
    eng = ServingEngine(det, HW, device_batch=8, score_thresh=-1.0, mesh=mesh)
    launches = _spy(eng)
    imgs = _requests(1, 11, seed=22)[0]  # 11 > device_batch, not /4
    out = list(eng.map_stream([(imgs, None)]))
    assert len(out) == 1 and len(out[0]) == 11
    assert launches == [12], launches  # rounded up to the 4-device mesh
    for a, b in zip(out[0], det.detect_batch(imgs, score_thresh=-1.0)):
        _close(a, b)
    with pytest.raises(ValueError):
        ServingEngine(det, HW, device_batch=6, mesh=mesh)  # 6 % 4 != 0


def test_mesh_validation_messages_are_jax(det, jax_det):
    """The validation errors carry the JAX engine's messages (the port's
    mesh of 8 logical replicas against JAX's 8 fake devices)."""
    mesh, jmesh = _mesh(8), jsh.data_mesh()
    assert mesh.size == jmesh.devices.size == 8
    cases = [dict(device_batch=12), dict(device_batch=16, batch_ladder=(4, 16)),
             dict(device_batch=16, batch_ladder=(8, 32))]
    for kw in cases:
        with pytest.raises(ValueError) as got:
            ServingEngine(det, HW, mesh=mesh, **kw)
        with pytest.raises(ValueError) as want:
            JServingEngine(jax_det, HW, mesh=jmesh, **kw)
        assert str(got.value) == str(want.value)
    eng, jeng = ServingEngine(det, HW, device_batch=16, mesh=mesh), JServingEngine(jax_det, HW, device_batch=16,
                                                                                   mesh=jmesh)
    assert eng.batch_ladder == jeng.batch_ladder == (8, 16)  # the small rung rounded up to the mesh


def test_router_mesh_passthrough(det):
    mesh = _mesh()
    with ServingRouter(det, device_batch=8, score_thresh=-1.0, mesh=mesh) as router:
        img = np.random.RandomState(33).randint(0, 255, (*HW, 3), np.uint8)
        d = router.submit(img).result(timeout=T_OUT)
        _close(d, det.detect(img, score_thresh=-1.0))
        assert next(iter(router._engines.values())).mesh is mesh


def test_dp_serving_picks_up_hot_reload(det):
    img = np.random.RandomState(40).randint(0, 255, (8, *HW, 3), np.uint8)
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0, mesh=_mesh()) as eng:
        before = eng.submit(img).result(timeout=T_OUT)
        det.reload_weights(variables=init_model(_cfg().model, seed=77)[1])
        after = eng.submit(img).result(timeout=T_OUT)
    assert not np.allclose(before[0].scores, after[0].scores)
    for a, b in zip(after, det.detect_batch(img, score_thresh=-1.0)):
        _close(a, b)


def test_dp_cache_evicts_stale_versions(det):
    img = np.zeros((8, *HW, 3), np.uint8)
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0, mesh=_mesh()) as eng:
        for seed in (50, 51):
            det.reload_weights(variables=init_model(_cfg().model, seed=seed)[1])
            eng.submit(img).result(timeout=T_OUT)
        versions = {k[-1] for k in eng._dp_cache}
    assert versions == {det.weights_version}, versions


def test_dp_cache_keeps_current_version_rungs(det):
    det.reload_weights(variables=init_model(_cfg().model, seed=52)[1])  # ver >= 1
    with ServingEngine(det, HW, device_batch=16, score_thresh=-1.0, mesh=_mesh(8)) as eng:
        assert eng.batch_ladder == (8, 16)
        eng.submit(np.zeros((16, *HW, 3), np.uint8)).result(timeout=T_OUT)
        eng.submit(np.zeros((1, *HW, 3), np.uint8)).result(timeout=T_OUT)
        rungs = {k[0] for k in eng._dp_cache}
        versions = {k[3] for k in eng._dp_cache}
    assert rungs == {8, 16}, rungs
    assert versions == {det.weights_version}, versions


def test_dp_replica_on_another_device_follows_swaps(det):
    """A mesh device other than the detector's runs a `Detector.replica`
    (here "cpu:0", another device object for the same memory): its results
    equal the detector's, and a reload rebuilds it on the new weights."""
    mesh = data_mesh(devices=["cpu", "cpu:0"])
    img = np.random.RandomState(41).randint(0, 255, (8, *HW, 3), np.uint8)
    with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0, mesh=mesh) as eng:
        first = eng.submit(img).result(timeout=T_OUT)
        assert {k[0] for k in eng._replicas} == {torch.device("cpu", 0)}
        det.reload_weights(variables=init_model(_cfg().model, seed=78)[1])
        second = eng.submit(img).result(timeout=T_OUT)
        assert {k[1] for k in eng._replicas} == {det.weights_version}
    for dets in (first, second):
        assert len(dets) == 8
    for a, b in zip(second, det.detect_batch(img, score_thresh=-1.0)):
        _close(a, b)
    assert not np.allclose(first[4].scores, second[4].scores)


def test_dp_int8_input_serving_matches_single_device(det):
    """int8_input staging composes with mesh= DP serving: bit for bit
    against the single-device int8_input engine, on the detector's device
    and on a replica's (its quantized forward installed from the scales
    and params)."""
    rng = np.random.RandomState(45)
    det.quantize(calib_images=rng.randint(0, 255, (4, *HW, 3), np.uint8), int8_dw=True)
    reqs = _requests(3, 4, seed=46)  # 12 images over device_batch 8
    ref = list(ServingEngine(det, HW, device_batch=8, score_thresh=-1.0, int8_input=True).map_stream(
        (r, None) for r in reqs))
    for mesh in (_mesh(), data_mesh(devices=["cpu", "cpu:0"])):
        with ServingEngine(det, HW, device_batch=8, score_thresh=-1.0, mesh=mesh, int8_input=True) as eng:
            dp = [f.result(timeout=T_OUT) for f in [eng.submit(r) for r in reqs]]
        for rs, gs in zip(ref, dp):
            for rd, gd in zip(rs, gs):
                np.testing.assert_array_equal(rd.boxes, gd.boxes)
                np.testing.assert_array_equal(rd.scores, gd.scores)


# --------------------------------------------------------------------------- #
# shard_train_step
# --------------------------------------------------------------------------- #

SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 1, 2), (6, 64, 1, 2), (6, 160, 1, 2))
MODEL = dict(inverted_residual_setting=SETTING, width_mult=0.5, compute_dtype="float32")
TRAIN = dict(input_size=64, batch_size=4, max_objs=8, lr=1e-3, ema_decay=0.9, grad_clip_norm=1.0)


def _train_batch(seed=0, b=4, size=64):
    """uint8 images with 1 to 4 random boxes each (so the positives and the
    mask sums differ between rows)."""
    from tpucenterface_torch.data.targets import make_targets

    rng = np.random.RandomState(seed)
    samples = []
    for i in range(b):
        n = 1 + i % 4
        xy = rng.uniform(0, size - 24, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (n, 2))], axis=1).astype(np.float32)
        t = make_targets(boxes, size, max_objs=8)
        t["image"] = rng.randint(0, 256, (size, size, 3)).astype(np.uint8)
        samples.append(t)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _plain_step(variables, batch):
    tcfg = TrainConfig(**TRAIN)
    tx = pstep.make_optimizer(tcfg)
    state = pstep.train_state_from_variables(variables, tx, ema=True, device="cpu")
    step = pstep.make_train_step(CenterFaceNet(ModelConfig(**MODEL)), tx, tcfg)
    return step, state


@contextlib.contextmanager
def _one_rank_group():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_shard_train_step_without_a_group_is_the_step():
    _, v = init_model(ModelConfig(**MODEL), seed=0)
    batch = _train_batch()
    step, state = _plain_step(v, batch)
    want, wm = step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
    dstep, dstate = pstep.shard_train_step(step, data_mesh(devices=["cpu"]), state)
    got, gm = dstep(dstate, put_sharded(batch, data_mesh(devices=["cpu"])))
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    for (path, a), (_, b) in zip(pstep.tree_paths(got.params), pstep.tree_paths(want.params)):
        assert torch.equal(a, b), path
    with pytest.raises(ValueError, match="one process per device"):
        pstep.shard_train_step(step, _mesh(2), state)


def test_shard_train_step_on_a_one_rank_group_matches_the_step():
    """The collective path (BatchNorm moments, loss normalizers, gradients
    and metrics all-reduced) on a one-rank gloo group against the plain
    step: bit for bit, since one rank's share of the global count is exactly
    1 and a one-rank sum is its operand."""
    _, v = init_model(ModelConfig(**MODEL), seed=0)
    batch = _train_batch()
    step, state = _plain_step(v, batch)
    want, wm = step(state, {k: torch.from_numpy(x) for k, x in batch.items()})
    with _one_rank_group():
        mesh = data_mesh()
        assert (mesh.world_size, mesh.devices) == (1, (torch.device("cpu"),))
        dstep, dstate = pstep.shard_train_step(step, mesh, state)
        got, gm = dstep(dstate, put_sharded(batch, mesh))
    for k in wm:
        assert torch.equal(gm[k], wm[k]), k
    for name in ("params", "batch_stats", "ema_params"):
        for (path, a), (_, b) in zip(pstep.tree_paths(getattr(got, name)), pstep.tree_paths(getattr(want, name))):
            assert torch.equal(a, b), (name, path)
