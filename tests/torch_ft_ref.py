"""Shared pieces of the fine-tuning tests of the port (`tests/test_torch_qat.py`,
`tests/test_torch_adaround.py`, `tests/test_torch_packed_weights.py`): the
small float32 model of `tests/test_adaround.py` and `tests/test_w4.py` in
both packages' configs, and a way to run the JAX package's fine-tuning code
jitted but with the arithmetic of its op-by-op run.

Why that is needed: jitted on the CPU, XLA rewrites a division by a constant
(every activation scale is one in the JAX engine's trace) into a
multiplication by its reciprocal, and keeps bf16 intermediates in float32
(`xla_allow_excess_precision`). Both move fake-quantized and quantized values
across grid points, so the jitted JAX functions differ from the same
functions run op by op (`jax.disable_jit()`) by ~1% in their losses. The port
computes as the op-by-op run does, and that run is far too slow for the fast
tests (~35 s of per-op compiles for one `qat_finetune(steps=0)`). `exact_jax`
hides each activation scale behind `jax.lax.optimization_barrier` and
compiles every `jax.jit` with excess precision off: measured on
`qat_finetune(steps=0)`, loss_first then equals the op-by-op run's bit for
bit, in ~7 s.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax  # noqa: F401  (imported before `exact_jax` patches jax.jit: its own jitted functions stay plain)

from tpucenterface.config import ModelConfig as JModel
from tpucenterface.model.centernet import init_model as jinit
from tpucenterface.weights.fold import fold_variables as jfold

SIZE = 64
SETTING = ((1, 8, 1, 1), (4, 16, 1, 2), (4, 16, 1, 2), (4, 24, 1, 2), (4, 24, 1, 1), (4, 32, 1, 2), (4, 32, 1, 1))
SMALL = dict(inverted_residual_setting=SETTING, stem_channels=8, fpn_channels=16, head_conv=16)
JCFG = JModel(compute_dtype="float32", **SMALL)
KEYS = ["hm", "whoff"]


def port_cfg(**kw):
    import tpucenterface_torch as T

    return T.ModelConfig(compute_dtype="float32", **SMALL, **kw)


@functools.lru_cache(maxsize=None)
def _small_variables(seed):
    return jax.device_get(jinit(JCFG, rng=jax.random.PRNGKey(seed), input_size=SIZE)[1])


def small_variables(seed=0):
    """The small model's unfolded variables from `seed` as a numpy tree (a
    fresh copy of one cached draw: the draw is a JAX init, ~1 s)."""
    return jax.tree.map(np.copy, _small_variables(seed))


def folded_small(seed=6):
    """JAX-folded variables of the small model as a numpy tree."""
    _, v = jinit(JCFG, rng=jax.random.PRNGKey(seed), input_size=SIZE)
    return jax.device_get(jfold(v))


def calib(seed, n=2, batch=2):
    rng = np.random.RandomState(seed)
    return [(rng.rand(batch, SIZE, SIZE, 3) * 2 - 1).astype(np.float32) for _ in range(n)]


def _strict_jit(real_jit):
    def jit(fn=None, **kw):
        jitted = real_jit(fn, **kw)
        static = set(kw.get("static_argnames", ()))
        cache = {}

        def call(*args, **kwargs):
            dyn = {k: v for k, v in kwargs.items() if k not in static}
            stat = tuple(sorted((k, v) for k, v in kwargs.items() if k in static))
            leaves, tree = jax.tree.flatten((args, dyn))
            if any(isinstance(a, jax.core.Tracer) for a in leaves):
                return jitted(*args, **kwargs)  # inside another trace: inlined there
            key = (tree, stat, tuple((np.shape(a), jnp.result_type(a)) for a in leaves))
            if key not in cache:
                cache[key] = jitted.lower(*args, **kwargs).compile(
                    compiler_options={"xla_allow_excess_precision": False})
            return cache[key](*args, **dyn)

        return call

    return jit


@contextlib.contextmanager
def exact_jax(*engines):
    """Within: each JAX engine's activation scales sit behind an
    optimization barrier, and `jax.jit` compiles with excess precision off
    (see the module docstring)."""
    real_jit = jax.jit
    for eng in engines:
        scale = eng._act_scale
        eng._act_scale = lambda tag, f=scale: jax.lax.optimization_barrier(f(tag))
    jax.jit = _strict_jit(real_jit)
    try:
        yield
    finally:
        jax.jit = real_jit
        for eng in engines:
            del eng._act_scale


def jit_exact(fn, *args):
    """`fn(*args)` jitted with excess precision off."""
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_allow_excess_precision": False})(*args)


def np_tree(tree):
    """A tree of tensors or arrays as numpy arrays, keyed by path tuples."""
    from tpucenterface_torch.train.step import tree_paths

    return {p: (a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)) for p, a in tree_paths(tree)}
