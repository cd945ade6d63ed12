"""Two-process data parallelism on torch.distributed (gloo, the CPU): the
port's counterpart of tests/test_multihost.py.

The test writes the weights, the images and a training batch (numpy, from
seeds) to a temporary directory and starts this file twice as a script, one
process per rank, joined over a free local port
(`runtime.sharding.maybe_init_distributed`). Each rank feeds its own rows of
the global batch (`process_local_batch_bounds`, `put_sharded`), runs one
data-parallel detect launch (`shard_batch_fn` over the Detector's batch
program) and one data-parallel train step (`shard_train_step`), the step
once more on a batch from `prefetch_to_device(sharding=)`, and writes its
rows and its new state. Here, both ranks must agree with each other (the
new state bit for bit: every rank takes the same reduced step) and with the
single-process steps on the global batch:
- detections against the JAX Detector's on the whole batch: scores within
  1e-5 (float32, as tests/test_multihost.py);
- the train step against the JAX step (`tests/test_torch_train.py`'s
  bounds: loss and its terms rtol 1e-5; gradients, read from Adam's first
  moment, within 1e-4 of the largest plus 1e-3 of the tensor's own largest;
  new params within 1e-3 * lr + 1e-7 where JAX's gradient is above 1e-4 of
  the largest, within 2 * lr elsewhere; BatchNorm's new mean within 1e-5 of
  its deviation, its variance rtol 1e-5) and against the port's own
  single-process step (loss rtol 1e-6; the same param bounds). Each image
  has another number of boxes, so the positives, the mask sums and the
  BatchNorm moments of one rank's rows differ from the global batch's: a
  per-rank normalizer or per-replica BatchNorm would miss these bounds.

Every subprocess has a timeout.
"""

import os
import socket
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
B, SIZE = 4, 64
SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 1, 2), (6, 64, 1, 2), (6, 160, 1, 2))
MODEL = dict(inverted_residual_setting=SETTING, width_mult=0.5, compute_dtype="float32",
             bn_compute_dtype="float32")
TRAIN = dict(input_size=SIZE, batch_size=B, max_objs=8, lr=1e-3, ema_decay=0.9, grad_clip_norm=1.0)
LR = TRAIN["lr"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _unflat(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


# --------------------------------------------------------------------------- #
# the worker: one rank (run as a script; torch and the port only)
# --------------------------------------------------------------------------- #


def worker(coord: str, rank: int, nprocs: int, data_dir: str) -> None:
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    import tpucenterface_torch as T
    from tpucenterface_torch.config import ModelConfig, TrainConfig
    from tpucenterface_torch.model.centernet import CenterFaceNet
    from tpucenterface_torch.runtime.prefetch import prefetch_to_device
    from tpucenterface_torch.runtime.sharding import (
        batch_sharding,
        data_mesh,
        maybe_init_distributed,
        process_local_batch_bounds,
        put_sharded,
        shard_batch_fn,
    )
    from tpucenterface_torch.train import step as pstep

    assert maybe_init_distributed(coordinator_address=coord, num_processes=nprocs, process_id=rank, backend="gloo")
    mesh = data_mesh()
    assert (mesh.world_size, mesh.rank, mesh.size) == (nprocs, rank, nprocs)
    lo, hi = process_local_batch_bounds(B)

    det_vars = _unflat(_load(os.path.join(data_dir, "det_vars.npz")))
    imgs = np.load(os.path.join(data_dir, "imgs.npy"))
    hws = np.tile(np.array([[SIZE, SIZE]], np.int32), (B, 1))
    det = T.Detector(variables=det_vars, config=T.DetectorConfig(model=ModelConfig(**MODEL), default_size=SIZE),
                     device="cpu")
    fn = shard_batch_fn(det._batch_fn(B, (SIZE, SIZE), SIZE), mesh, num_batch_args=2)
    boxes, scores = fn(put_sharded(imgs, mesh), put_sharded(hws, mesh))

    train_vars = _unflat(_load(os.path.join(data_dir, "train_vars.npz")))
    batch = _load(os.path.join(data_dir, "batch.npz"))
    tcfg = TrainConfig(**TRAIN)
    tx = pstep.make_optimizer(tcfg)
    step = pstep.make_train_step(CenterFaceNet(ModelConfig(**MODEL)), tx, tcfg)
    out = {"rows": np.array([lo, hi]), "scores": scores.numpy(), "boxes": boxes.numpy()}
    for name, feed in (("put", put_sharded(batch, mesh)),
                       ("prefetch", list(prefetch_to_device([batch], size=2, sharding=batch_sharding(mesh)))[0])):
        state = pstep.train_state_from_variables(train_vars, tx, ema=True, device="cpu")
        dstep, dstate = pstep.shard_train_step(step, mesh, state)
        new, metrics = dstep(dstate, feed)
        for k, v in metrics.items():
            out[f"{name}/metrics/{k}"] = v.numpy()
        for col, tree in (("params", new.params), ("batch_stats", new.batch_stats), ("mu", new.opt_state["mu"]),
                          ("ema", new.ema_params)):
            for path, t in pstep.tree_paths(tree):
                out[f"{name}/{col}/" + "/".join(path)] = t.numpy()
    np.savez(os.path.join(data_dir, f"rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


# --------------------------------------------------------------------------- #
# the test
# --------------------------------------------------------------------------- #


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_dp_matches_single_process(tmp_path):
    import jax
    import jax.numpy as jnp
    import torch

    from test_torch_sharding import _train_batch
    from test_torch_train import _adam_state, _jax_step
    from tpucenterface.config import DecodeConfig as JDecode
    from tpucenterface.config import DetectorConfig as JDetectorConfig
    from tpucenterface.config import ModelConfig as JModel
    from tpucenterface.detector import Detector as JDetector
    from tpucenterface_torch.config import ModelConfig, TrainConfig
    from tpucenterface_torch.model.centernet import CenterFaceNet, init_model
    from tpucenterface_torch.train import step as pstep

    det_vars = init_model(ModelConfig(**MODEL), seed=0)[1]
    train_vars = init_model(ModelConfig(**MODEL), seed=1)[1]
    imgs = np.random.RandomState(42).randint(0, 255, (B, SIZE, SIZE, 3), np.uint8)
    batch = _train_batch(seed=3, b=B, size=SIZE)
    np.savez(tmp_path / "det_vars.npz", **_flat(det_vars))
    np.savez(tmp_path / "train_vars.npz", **_flat(train_vars))
    np.save(tmp_path / "imgs.npy", imgs)
    np.savez(tmp_path / "batch.npz", **batch)

    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), coord, str(r), "2", str(tmp_path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"rank failed rc={p.returncode}\n{out.decode()[-2000:]}\n{err.decode()[-3000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [_load(tmp_path / f"rank{r}.npz") for r in range(2)]
    assert [list(r["rows"]) for r in ranks] == [[0, 2], [2, 4]]

    # detect: each rank's rows against the JAX Detector on the global batch
    ref = JDetector(variables=det_vars, config=JDetectorConfig(
        model=JModel(**MODEL), decode=JDecode(fast_topk=False), default_size=SIZE))
    hws = np.tile(np.array([[SIZE, SIZE]], np.int32), (B, 1))
    jboxes, jscores = ref._batch_fn(B, (SIZE, SIZE), SIZE)(jnp.asarray(imgs), jnp.asarray(hws))
    got_scores = np.concatenate([r["scores"] for r in ranks])
    np.testing.assert_allclose(got_scores, np.asarray(jscores), atol=1e-5)
    np.testing.assert_allclose(np.concatenate([r["boxes"] for r in ranks]), np.asarray(jboxes), atol=1e-3)

    # the ranks agree: the same reduced step, bit for bit, by either feed
    keys = [k for k in ranks[0] if k.startswith("put/")]
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
        np.testing.assert_array_equal(ranks[0][k], ranks[0]["prefetch/" + k[4:]], err_msg=k)
    got = {k[4:]: v for k, v in ranks[0].items() if k.startswith("put/")}

    # the JAX step and the port's single-process step on the global batch
    jnew, jm = _jax_step(train_vars, TRAIN, MODEL, batch)
    tcfg = TrainConfig(**TRAIN)
    tx = pstep.make_optimizer(tcfg)
    state = pstep.train_state_from_variables(train_vars, tx, ema=True, device="cpu")
    pnew, pm = pstep.make_train_step(CenterFaceNet(ModelConfig(**MODEL)), tx, tcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in jm:
        np.testing.assert_allclose(float(got[f"metrics/{k}"]), jm[k], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(got[f"metrics/{k}"]), float(pm[k]), rtol=1e-6, err_msg=k)
    jmu = _flat(jax.tree.map(np.asarray, _adam_state(jnew.opt_state).mu))
    gmax = max(np.abs(x).max() for x in jmu.values())
    jparams, jema = _flat(jax.tree.map(np.asarray, jnew.params)), _flat(jax.tree.map(np.asarray, jnew.ema_params))
    pparams = {"/".join(p): t.numpy() for p, t in pstep.tree_paths(pnew.params)}
    for path, want in jmu.items():
        err = np.abs(got["mu/" + path] - want).max()
        assert err <= 1e-4 * gmax + 1e-3 * np.abs(want).max(), (path, err, gmax)
        firm = np.abs(want) > 1e-4 * gmax
        for name, ref_tree in (("params", jparams), ("ema", jema), ("params", pparams)):
            d = np.abs(got[f"{name}/{path}"] - ref_tree[path])
            assert (d[firm] <= 1e-3 * LR + 1e-7).all(), (name, path, d[firm].max())
            assert (d <= 2 * LR + 1e-7).all(), (name, path, d.max())
    jstats = _flat(jax.tree.map(np.asarray, jnew.batch_stats))
    for path, want in jstats.items():
        g = got["batch_stats/" + path]
        if path.endswith("mean"):
            assert (np.abs(g - want) <= 1e-5 * np.sqrt(jstats[path[:-4] + "var"])).all(), path
        else:
            np.testing.assert_allclose(g, want, rtol=1e-5, err_msg=path)


if __name__ == "__main__":
    worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
