"""The port's train step against the JAX package's (`tpucenterface/train/`).

A narrow, shallow model (width 0.5, six blocks, one of them residual, 64 px,
batch 4); its
variables are drawn once and carried to both sides as numpy, BatchNorm's
running statistics randomized so that the frozen step does not normalize
with the identity. The affine stays at its init (scale 1, bias 0): with
random biases the batch statistics of the first layers become
ill-conditioned in float32, and the two frameworks' float32 gradients there
then part by far more than float32 rounding of well-conditioned sums, so
the bounds below hold the port to JAX where both are accurate, and
`test_float32_step_near_float64` holds the port's float32 to its own
float64 run on random affines. The batch is uint8 BGR with targets rendered by
`data.targets` from random boxes. Tolerances (float32, measured on the CPU):
- loss and each term: rtol 1e-5 (seen 1.4e-6);
- gradients, read from Adam's first moment (mu = (1 - b1) * g after one
  step from zero moments): each tensor within 1e-4 of the network's largest
  gradient element plus 1e-3 of its own largest (seen 1.0e-5 and 3.5e-5);
- new params: within 1e-3 * lr + 1e-7 wherever JAX's gradient is above
  1e-4 of the network's largest (seen 1.2e-7 at lr 1e-3). Elsewhere the
  gradient is rounding noise (a project BatchNorm's bias ahead of a
  train-mode BatchNorm has an analytic gradient of 0), and Adam's first
  step, g / (|g| + eps), turns that noise into +-lr: those are within 2 * lr;
- new batch_stats: the mean within 1e-5 * sqrt(var), the variance within
  rtol 1e-5 (seen 3.4e-7 and 1.9e-6); the EMA as the params;
- the optimizer alone on identical numpy gradients: updates within 1e-4 *
  lr, moments within rtol 1e-5, over steps that cross both LR drops;
- bfloat16 compute and BatchNorm: the loss after two steps within 2% of
  JAX's (the bound of tests/test_train.py::test_bf16_bn_training_matches_f32);
- remat: bit-equal to the step without it;
- the port's float32 gradients against its float64 run, random BatchNorm
  affines: within 1e-5 of the largest gradient (seen 2.4e-6, frozen 1.3e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpucenterface.config import ModelConfig as JModel
from tpucenterface.config import TrainConfig as JTrain
from tpucenterface.model.centernet import init_model as jinit
from tpucenterface.train import losses as jlosses
from tpucenterface.train import step as jstep
from tpucenterface_torch.config import ModelConfig, TrainConfig
from tpucenterface_torch.data.targets import make_targets
from tpucenterface_torch.model.blocks import BatchNorm
from tpucenterface_torch.model.centernet import CenterFaceNet, init_model
from tpucenterface_torch.train import losses
from tpucenterface_torch.train import step as pstep
from torch_threads import one_torch_thread  # noqa: F401  (autouse: torch on one thread)

# one block a stage but two at stride 4, so that a residual block is in it
SETTING = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 1, 2), (6, 64, 1, 2), (6, 160, 1, 2))
SIZE, B, LR = 64, 4, 1e-3
F64_GMAX = 1e-5


def _mkw(dtype="float32", **kw):
    return dict(inverted_residual_setting=SETTING, width_mult=0.5, compute_dtype=dtype, bn_compute_dtype=dtype, **kw)


def _tkw(**kw):
    return dict(dict(input_size=SIZE, batch_size=B, max_objs=8, lr=LR, ema_decay=0.9, grad_clip_norm=1.0), **kw)


def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def variables():
    """The port's init drawn from a seed (numpy), its BatchNorm running
    statistics randomized around the identity (they matter to the frozen
    step only; the affine stays at its init, see the module docstring)."""
    _, v = init_model(ModelConfig(**_mkw()), seed=0)
    rng = np.random.RandomState(0)
    for path, x in list(pstep.tree_paths(v["batch_stats"])):
        lo, hi = (-0.3, 0.3) if path[-1] == "mean" else (0.7, 1.3)
        node = v["batch_stats"]
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = rng.uniform(lo, hi, x.shape).astype(np.float32)
    return v


def _batch(seed=0):
    """uint8 BGR images with targets of random boxes (numpy)."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(B):
        xy = rng.uniform(0, SIZE - 24, (3, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (3, 2))], axis=1).astype(np.float32)
        t = make_targets(boxes, SIZE, max_objs=8)
        t["image"] = rng.randint(0, 256, (SIZE, SIZE, 3)).astype(np.uint8)
        samples.append(t)
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


def _jax_step(variables, tkw, mkw, batch, frozen=False, steps=1):
    tcfg = JTrain(**tkw)
    model = jinit.__globals__["CenterFaceNet"](JModel(**mkw))
    tx = jstep.make_optimizer(tcfg)
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = jstep.TrainState(params=params, batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
                             opt_state=tx.init(params), step=jnp.zeros((), jnp.int32),
                             ema_params=jax.tree.map(jnp.array, params) if tcfg.ema_decay > 0 else None)
    fn = jax.jit(jstep.make_train_step(model, tx, tcfg, frozen_bn=frozen))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(steps):
        state, metrics = fn(state, jb)
    return jax.device_get(state), {k: float(v) for k, v in metrics.items()}


def _port_step(variables, tkw, mkw, batch, frozen=False, steps=1):
    tcfg = TrainConfig(**tkw)
    tx = pstep.make_optimizer(tcfg)
    state = pstep.train_state_from_variables(variables, tx, ema=tcfg.ema_decay > 0, device="cpu")
    fn = pstep.make_train_step(CenterFaceNet(ModelConfig(**mkw)), tx, tcfg, frozen_bn=frozen)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(steps):
        state, metrics = fn(state, tb)
    return state, {k: float(v) for k, v in metrics.items()}


def _adam_state(opt_state):
    """optax's ScaleByAdamState inside the chain's state."""
    return [s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")][0]


def _np(tree):
    return pstep.tree_map(lambda t: t.numpy(), tree)


@pytest.mark.parametrize("frozen", [False, True], ids=["live", "frozen_bn"])
def test_train_step_matches_jax(variables, frozen):
    """One float32 step from the same variables: loss and terms, gradients
    (Adam's mu), params, batch_stats and EMA (module docstring bounds).
    FrozenBN leaves the statistics bit-identical on both sides."""
    batch = _batch()
    jnew, jm = _jax_step(variables, _tkw(), _mkw(), batch, frozen)
    pnew, pm = _port_step(variables, _tkw(), _mkw(), batch, frozen)
    assert set(jm) == set(pm) == {"loss", "hm_loss", "wh_loss", "off_loss"}
    for k in jm:
        np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5, err_msg=k)
    assert int(pnew.step) == 1 and int(pnew.opt_state["count"]) == 1
    jmu = _np_tree(_adam_state(jnew.opt_state).mu)
    gmax = max(np.abs(x).max() for _, x in pstep.tree_paths(jmu))
    params, ema = _np(pnew.params), _np(pnew.ema_params)
    for path, got in pstep.tree_paths(_np(pnew.opt_state["mu"])):
        want = _leaf(jmu, path)
        err = np.abs(got - want).max()
        assert err <= 1e-4 * gmax + 1e-3 * np.abs(want).max(), (path, err, gmax)
        firm = np.abs(want) > 1e-4 * gmax
        for name, tree, ref in (("params", params, jnew.params), ("ema", ema, jnew.ema_params)):
            d = np.abs(_leaf(tree, path) - _leaf(ref, path))
            assert (d[firm] <= 1e-3 * LR + 1e-7).all(), (name, path, d[firm].max())
            assert (d <= 2 * LR + 1e-7).all(), (name, path, d.max())
    for path, got in pstep.tree_paths(pnew.batch_stats):
        got, want = got.numpy(), _leaf(jnew.batch_stats, path)
        if frozen:
            np.testing.assert_array_equal(got, _leaf(variables["batch_stats"], path))
            np.testing.assert_array_equal(want, _leaf(variables["batch_stats"], path))
        elif path[-1] == "mean":
            scale = np.sqrt(_leaf(jnew.batch_stats, path[:-1] + ("var",)))
            assert (np.abs(got - want) <= 1e-5 * scale).all(), path
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("frozen", [False, True], ids=["live", "frozen_bn"])
def test_float32_step_near_float64(variables, frozen):
    """The port's float32 gradients against its own float64 run (compute and
    BatchNorm in float64) from the same variables with random BatchNorm
    affines, where the first layers' batch statistics are ill-conditioned:
    each tensor within F64_GMAX of the largest gradient element."""
    rng = np.random.RandomState(9)
    v = {"params": pstep.tree_map(lambda x: x.copy(), variables["params"]), "batch_stats": variables["batch_stats"]}
    for path, x in pstep.tree_paths(v["params"]):
        if path[-2] == "bn":
            lo, hi = (0.7, 1.3) if path[-1] == "scale" else (-0.2, 0.2)
            x[...] = rng.uniform(lo, hi, x.shape)
    batch = _batch(5)
    grads = {}
    for dt in ("float32", "float64"):
        tdt = getattr(torch, dt)
        put = lambda x: torch.from_numpy(np.array(x, np.float64)).to(tdt)  # noqa: E731
        tcfg = TrainConfig(**_tkw(grad_clip_norm=0.0))
        fn = pstep.make_loss_fn(CenterFaceNet(ModelConfig(**_mkw(dt))), tcfg, frozen_bn=frozen)
        tb = {k: torch.from_numpy(x) for k, x in batch.items()}
        g, _, _ = fn(pstep.tree_map(put, v["params"]), pstep.tree_map(put, v["batch_stats"]), tb)
        grads[dt] = _np(g)
    gmax = max(np.abs(x).max() for _, x in pstep.tree_paths(grads["float64"]))
    err = max(np.abs(x - _leaf(grads["float64"], p)).max() for p, x in pstep.tree_paths(grads["float32"]))
    assert err <= F64_GMAX * gmax, (err, gmax)


@pytest.mark.slow
def test_bf16_step_loss_within_2pct(variables):
    """bfloat16 convolutions and BatchNorm on both sides: the loss of the
    second step within 2% of JAX's; the running statistics stay float32."""
    batch = _batch(1)
    mkw = _mkw("bfloat16")
    _, jm = _jax_step(variables, _tkw(), mkw, batch, steps=2)
    pnew, pm = _port_step(variables, _tkw(), mkw, batch, steps=2)
    assert abs(pm["loss"] - jm["loss"]) < 0.02 * abs(jm["loss"]), (pm, jm)
    assert {x.dtype for _, x in pstep.tree_paths(pnew.batch_stats)} == {torch.float32}
    assert {x.dtype for _, x in pstep.tree_paths(pnew.params)} == {torch.float32}


@pytest.mark.parametrize("frozen", [False, True], ids=["live", "frozen_bn"])
def test_remat_matches_no_remat(variables, frozen):
    """remat=True (the forward under torch.utils.checkpoint, run again in
    the backward) gives the state of remat=False bit for bit over two steps:
    the recompute does not apply the running-statistics update twice."""
    batch = _batch(2)
    a, am = _port_step(variables, _tkw(remat=False), _mkw(), batch, frozen, steps=2)
    b, bm = _port_step(variables, _tkw(remat=True), _mkw(), batch, frozen, steps=2)
    assert am == bm
    for name in ("params", "batch_stats", "ema_params"):
        for (pa, x), (pb, y) in zip(pstep.tree_paths(getattr(a, name)), pstep.tree_paths(getattr(b, name))):
            assert pa == pb and torch.equal(x, y), (name, pa)


@pytest.mark.parametrize(
    "case",
    [dict(), dict(grad_clip_norm=1.0), dict(grad_clip_norm=1e3), dict(weight_decay=1e-2),
     dict(grad_clip_norm=2.0, weight_decay=1e-3)],
    ids=["adam", "clip_active", "clip_inactive", "weight_decay", "clip_and_decay"])
def test_optimizer_matches_optax(case):
    """make_optimizer against optax's chain on identical numpy gradients,
    six steps with LR drops at steps 2 and 4 (count >= boundary, read
    before the increment): updates within 1e-4 * lr, moments rtol 1e-5."""
    tkw = dict(lr=LR, lr_drops=(2, 4), lr_drop_factor=0.1, **case)
    jtx, ptx = jstep.make_optimizer(JTrain(**tkw), 1), pstep.make_optimizer(TrainConfig(**tkw), 1)
    rng = np.random.RandomState(0)
    params = {"a": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)}, "b": rng.randn(8).astype(np.float32)}
    js, ps = jtx.init(params), ptx.init(pstep.tree_map(torch.from_numpy, params))
    for i in range(6):
        g = pstep.tree_map(lambda x: (rng.randn(*x.shape) * (0.3 + i)).astype(np.float32), params)
        ju, js = jtx.update(g, js, params)
        pu, ps = ptx.update(pstep.tree_map(torch.from_numpy, g), ps, pstep.tree_map(torch.from_numpy, params))
        lr = LR * 0.1 ** ((i >= 2) + (i >= 4))
        for path, u in pstep.tree_paths(pu):
            want = _leaf(ju, path)
            np.testing.assert_allclose(u.numpy(), want, rtol=0, atol=1e-4 * lr, err_msg=f"step {i} {path}")
            assert np.abs(want).max() > 0.5 * lr
        adam = _adam_state(js)
        assert int(ps["count"]) == int(adam.count) == i + 1
        for name in ("mu", "nu"):
            for path, m in pstep.tree_paths(ps[name]):
                want = _leaf(getattr(adam, name), path)
                np.testing.assert_allclose(m.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_learning_rate_schedule_boundaries():
    """The LR of optax's piecewise_constant_schedule at every count around
    the drops, float32 bit for bit."""
    import optax

    tx = pstep.make_optimizer(TrainConfig(lr=2e-3, lr_drops=(2, 3), lr_drop_factor=0.1), steps_per_epoch=5)
    sched = optax.piecewise_constant_schedule(2e-3, {10: 0.1, 15: 0.1})
    for count in range(20):
        got = tx.learning_rate(torch.tensor(count, dtype=torch.int32)).numpy()
        assert got == np.float32(sched(jnp.int32(count))), count


def test_losses_match_jax():
    """focal_loss, gather_at_ind, masked_l1 and detection_loss (landmarks
    on) on the same maps: float32 rounding (rtol 1e-6); the JAX tests'
    cases (tests/test_train.py) hold on the port."""
    rng = np.random.RandomState(3)
    out = {k: rng.randn(2, 16, 16, c).astype(np.float32) * 3 for k, c in (("hm", 1), ("wh", 2), ("off", 2), ("lm", 10))}
    tgt = {k: v for k, v in _batch(4).items() if k != "image"}
    tgt = {k: v[:2] for k, v in tgt.items()}
    tgt["hm"] = np.minimum(tgt["hm"][:, :16, :16], 1.0)
    tgt["ind"] = np.minimum(tgt["ind"], 255)
    tgt["lm"] = rng.randn(2, 8, 10).astype(np.float32)
    tgt["lm_mask"] = tgt["mask"] * (rng.rand(2, 8) > 0.3)
    cfg = TrainConfig()
    jt, jm = jlosses.detection_loss({k: jnp.asarray(v) for k, v in out.items()},
                                    {k: jnp.asarray(v) for k, v in tgt.items()}, JTrain())
    pt, pm = losses.detection_loss({k: torch.from_numpy(v) for k, v in out.items()},
                                   {k: torch.from_numpy(v) for k, v in tgt.items()}, cfg)
    assert set(pm) == set(jm) == {"loss", "hm_loss", "wh_loss", "off_loss", "lm_loss"}
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-6, err_msg=k)
    g = losses.gather_at_ind(torch.from_numpy(out["wh"]), torch.from_numpy(tgt["ind"]))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jlosses.gather_at_ind(jnp.asarray(out["wh"]),
                                                                              jnp.asarray(tgt["ind"]))))
    # tests/test_train.py's cases
    gt = torch.zeros(1, 8, 8, 1)
    gt[0, 4, 4, 0] = 1.0
    good = torch.full((1, 8, 8, 1), -6.0)
    good[0, 4, 4, 0] = 6.0
    assert losses.focal_loss(good, gt) < losses.focal_loss(torch.full((1, 8, 8, 1), -6.0), gt)
    feat = torch.arange(2 * 4 * 4 * 2, dtype=torch.float32).reshape(2, 4, 4, 2)
    ind = torch.tensor([[5], [0]])
    target = losses.gather_at_ind(feat, ind) + 1.0
    assert abs(float(losses.masked_l1(feat, target, ind, torch.ones(2, 1))) - 1.0) < 1e-6
    assert float(losses.masked_l1(feat, target + 100, ind, torch.zeros(2, 1))) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    """The port's BatchNorm in train mode against flax's nn.BatchNorm
    (use_running_average=False, momentum 0.9): output, new running mean and
    biased variance, and the input gradient, on a bfloat16 or float32 input
    with non-trivial running statistics."""
    from flax import linen as nn

    rng = np.random.RandomState(5)
    c = 12
    x = (rng.randn(4, 6, 6, c) * 2 + rng.randn(c)).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.uniform(-0.3, 0.3, c).astype(np.float32)
    mean, var = rng.uniform(-0.5, 0.5, c).astype(np.float32), rng.uniform(0.5, 1.5, c).astype(np.float32)
    jdt = jnp.dtype(dtype)
    mod = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jdt)
    v = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean, "var": var}}

    def f(xx):
        y, upd = mod.apply(v, xx.astype(jdt), mutable=["batch_stats"])
        return y.astype(jnp.float32).sum() * 0.5 + (y.astype(jnp.float32) ** 2).sum() * 0.01, (y, upd)

    (_, (jy, jupd)), jg = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
    bn = BatchNorm(c, 1e-5, 0.9)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = bn(xt.to(tdt), train=True).to(tdt)
    yf = y.float()
    (yf.sum() * 0.5 + (yf ** 2).sum() * 0.01).backward()
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(yf.permute(0, 2, 3, 1).detach().numpy(), np.asarray(jy.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.updated_stats[0].numpy(), np.asarray(jupd["batch_stats"]["mean"]), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(bn.updated_stats[1].numpy(), np.asarray(jupd["batch_stats"]["var"]), rtol=1e-5)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg), rtol=tol, atol=tol)
    # the module's own buffers are untouched: the step collects the new ones
    np.testing.assert_array_equal(bn.running_mean.numpy(), mean)


def test_block_kwargs_pass_bn_momentum():
    net = CenterFaceNet(ModelConfig(**_mkw(bn_momentum=0.8)))
    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    assert bns and {m.momentum for m in bns} == {0.8}


def test_init_model_distributions_match_flax():
    """init_model draws as flax does: the same keys and shapes; biases,
    BatchNorm and the heatmap prior equal; each conv kernel a truncated
    normal of std sqrt(1/fan_in)/0.8796 cut at two stds (fan_in 9 for a
    depthwise kernel), so that kernel / sqrt(1/fan_in) lies in +-2.2737 with
    std 1 on both sides; the pooled standardized draws of the two packages
    within a Kolmogorov-Smirnov distance of 0.02."""
    mcfg = _mkw(with_landmarks=True)
    _, jv = jinit(JModel(**mcfg), rng=jax.random.PRNGKey(0), input_size=SIZE)
    jv = _np_tree(jv)
    _, pv = init_model(ModelConfig(**mcfg), seed=0)
    _, pv2 = init_model(ModelConfig(**mcfg), seed=1)
    jflat, pflat = dict(pstep.tree_paths(jv)), dict(pstep.tree_paths(pv))
    assert set(jflat) == set(pflat)
    pooled = {"jax": [], "port": []}
    differ = False
    for path, j in jflat.items():
        p = pflat[path]
        assert p.shape == j.shape and p.dtype == np.float32, path
        if path[-1] != "kernel":
            np.testing.assert_array_equal(p, j, err_msg=str(path))
            continue
        differ |= not np.array_equal(p, _leaf(pv2, path))
        fan_in = int(np.prod(j.shape[:-1]))
        for name, w in (("jax", j), ("port", p)):
            z = w.reshape(-1) * np.sqrt(fan_in)
            assert np.abs(z).max() <= 2.0 / 0.87962566 + 1e-4, (name, path)
            assert abs(z.std() - 1.0) < 6.0 / np.sqrt(z.size) + 0.02, (name, path, z.std())
            pooled[name].append(z)
    assert differ, "the seed draws the kernels"
    a, b = np.sort(np.concatenate(pooled["jax"])), np.sort(np.concatenate(pooled["port"]))
    grid = np.linspace(-2.3, 2.3, 200)
    ks = np.abs(np.searchsorted(a, grid) / a.size - np.searchsorted(b, grid) / b.size).max()
    assert ks < 0.02, ks
    assert jflat[("params", "heads", "hm", "out", "bias")][0] == np.float32(ModelConfig().hm_bias_init)


def test_make_dummy_batch_matches_jax():
    tcfg = dict(max_objs=6, with_landmarks=True)
    j = jstep.make_dummy_batch(2, 32, JTrain(**tcfg))
    p = pstep.make_dummy_batch(2, 32, TrainConfig(**tcfg), device="cpu")
    assert set(j) == set(p)
    for k in j:
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(j[k]), err_msg=k)
