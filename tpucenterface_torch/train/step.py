"""The train step and its state.

Mirrors `tpucenterface/train/step.py` (`TrainState`, `make_optimizer`,
`make_train_state`, `make_train_step`, `shard_train_step`,
`make_dummy_batch`; `shard_train_step` is `replicate_state` and
`data_parallel_step`). The step is a pure
function (state, batch) -> (new state, metrics), as the JAX one is: it
allocates the new state and leaves its input as it was.

The state's trees are the JAX package's: nested dicts keyed by the flax paths
('params' -> 'backbone' -> 'stem' -> 'conv' -> 'kernel'), each leaf a float32
torch tensor in the flax layout (conv kernels HWIO). So checkpoints, exports
and the tests' comparisons with JAX read them as they are. The forward runs
the port's `CenterFaceNet` through `torch.func.functional_call`, each kernel
viewed as OIHW: the network module only gives the structure, and its own
parameters are never read or cast (`cast_convs_` is an inference-only step),
so the float32 masters are cast to the compute dtype at use, as flax does
with `param_dtype=float32`. One step at a time may run on a model object:
BatchNorm leaves its new statistics on its modules
(`model/blocks.py::BatchNorm.updated_stats`).

`make_optimizer` is the JAX package's optax chain written out with torch's
multi-tensor (`_foreach`) ops, in optax's order of operations:
`clip_by_global_norm` (where(norm < max, g, g / norm * max)), then
`add_decayed_weights` (g + wd * p), then `adam` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0: moments (1-b)*g^k + b*m, bias correction 1 - b^(count+1),
m_hat / (sqrt(v_hat) + eps)) scaled by -lr(count) from
`piecewise_constant_schedule` (each drop applies once count >= its boundary,
count read before the increment). Every operand is a device tensor or a
Python number: after its first call (which copies the normalize constants
to the device once) a step waits for nothing on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpucenterface_torch.config import ModelConfig, PreprocessConfig, TrainConfig, resolve_device
from tpucenterface_torch.model.blocks import BatchNorm
from tpucenterface_torch.model.centernet import CenterFaceNet, init_model
from tpucenterface_torch.runtime.sharding import Mesh, ShardedTensor, global_sum, sum_over_ranks
from tpucenterface_torch.train.losses import detection_loss
from tpucenterface_torch.weights.convert import torch_key

Tree = Dict[str, Any]


def tree_paths(tree: Tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    """[(path, leaf)] of a nested dict, keys sorted at every level (the leaf
    order of `jax.tree.leaves`)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += tree_paths(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _unzip(tree: Tree) -> Tuple[List[Tuple[str, ...]], List[Any]]:
    """(paths, leaves) of `tree_paths`."""
    pairs = tree_paths(tree)
    return [p for p, _ in pairs], [x for _, x in pairs]


def tree_build(paths: Sequence[Tuple[str, ...]], leaves: Sequence[Any]) -> Tree:
    """Inverse of `tree_paths`."""
    tree: Tree = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def tree_map(fn: Callable, tree: Tree) -> Tree:
    paths, leaves = _unzip(tree)
    return tree_build(paths, [fn(x) for x in leaves])


@dataclasses.dataclass
class TrainState:
    params: Tree
    batch_stats: Tree
    # {'count': int32 scalar, 'mu': tree, 'nu': tree} (Adam's count and moments)
    opt_state: Tree
    step: torch.Tensor  # int32 scalar on the device
    # the EMA weight set (TrainConfig.ema_decay > 0), else None
    ema_params: Optional[Tree] = None


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """The optax chain of `make_optimizer` (see the module docstring)."""

    lr: float
    boundaries: Tuple[Tuple[int, float], ...] = ()  # (step, scale), sorted
    weight_decay: float = 0.0
    grad_clip_norm: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, params: Tree) -> Tree:
        device = tree_paths(params)[0][1].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params)}

    def learning_rate(self, count: torch.Tensor) -> torch.Tensor:
        """piecewise_constant_schedule at `count` (float32 scalar)."""
        v = torch.full((), self.lr, dtype=torch.float32, device=count.device)
        for boundary, scale in self.boundaries:
            v = torch.where(count >= boundary, v * scale, v)
        return v

    def update(self, grads: Tree, opt_state: Tree, params: Tree) -> Tuple[Tree, Tree]:
        """(updates, new opt_state), as optax's `tx.update`."""
        paths, g = _unzip(grads)
        _, p = _unzip(params)
        if self.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            keep = norm < self.grad_clip_norm
            # x / 1 * 1 is x: both branches in one multi-tensor pass
            g = torch._foreach_div(g, torch.where(keep, 1.0, norm))
            g = torch._foreach_mul(g, torch.where(keep, 1.0, self.grad_clip_norm))
        if self.weight_decay > 0:
            g = torch._foreach_add(g, torch._foreach_mul(p, self.weight_decay))
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1), torch._foreach_mul(_unzip(opt_state["mu"])[1], b1))
        nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                                torch._foreach_mul(_unzip(opt_state["nu"])[1], b2))
        count = opt_state["count"]
        count_inc = count + 1
        n = count_inc.float()
        mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, n))
        nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, n))
        u = torch._foreach_div(mu_hat, torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps))
        u = torch._foreach_mul(u, -self.learning_rate(count))
        new_opt = {"count": count_inc, "mu": tree_build(paths, mu), "nu": tree_build(paths, nu)}
        return tree_build(paths, u), new_opt


def make_optimizer(cfg: TrainConfig, steps_per_epoch: int = 1) -> Optimizer:
    """Adam with epoch-boundary LR drops, weight decay and global-norm clip
    (`tpucenterface/train/step.py:43-55`)."""
    drops = {int(e * steps_per_epoch): cfg.lr_drop_factor for e in cfg.lr_drops}
    return Optimizer(
        lr=cfg.lr,
        boundaries=tuple(sorted(drops.items())),
        weight_decay=cfg.weight_decay,
        grad_clip_norm=cfg.grad_clip_norm,
    )


def train_state_from_variables(
    variables: Tree, tx: Optimizer, ema: bool = False, device=None
) -> TrainState:
    """A fresh TrainState (step 0, zero moments) holding JAX-layout
    `variables` {'params', 'batch_stats'} (numpy arrays or tensors) as
    float32 tensors on `device` (the GPU unless it names another)."""
    dev = resolve_device(device)

    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x, np.float32))
        return t.to(device=dev, dtype=torch.float32).clone()

    params = tree_map(put, variables["params"])
    return TrainState(
        params=params,
        batch_stats=tree_map(put, variables["batch_stats"]),
        opt_state=tx.init(params),
        step=torch.zeros((), dtype=torch.int32, device=dev),
        ema_params=tree_map(torch.clone, params) if ema else None,
    )


def make_train_state(
    model_cfg: ModelConfig,
    train_cfg: TrainConfig,
    seed: int = 0,
    steps_per_epoch: int = 1,
    device=None,
) -> Tuple[CenterFaceNet, TrainState, Optimizer]:
    """(network, state from `init_model(model_cfg, seed)`, optimizer)."""
    model, variables = init_model(model_cfg, seed=seed)
    tx = make_optimizer(train_cfg, steps_per_epoch)
    return model, train_state_from_variables(variables, tx, train_cfg.ema_decay > 0, device), tx


def _module_tensors(params: Tree, batch_stats: Tree) -> Dict[str, torch.Tensor]:
    """The JAX-layout trees as the network's state_dict names, kernels viewed
    HWIO -> OIHW."""
    out = {}
    for col, tree in (("params", params), ("batch_stats", batch_stats)):
        for path, leaf in tree_paths(tree, (col,)):
            key, is_kernel = torch_key(path)
            out[key] = leaf.permute(3, 2, 0, 1) if is_kernel else leaf
    return out


def _collect_stats(model: CenterFaceNet) -> Tree:
    """The new running statistics each BatchNorm left in `updated_stats`,
    as the batch_stats tree; clears them."""
    paths, leaves = [], []
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            (mean, var), m.updated_stats = m.updated_stats, None
            scope = tuple(name.split("."))
            paths += [scope + ("mean",), scope + ("var",)]
            leaves += [mean, var]
    return tree_build(paths, leaves)


def make_loss_fn(
    model: CenterFaceNet,
    train_cfg: TrainConfig,
    pre_cfg: PreprocessConfig = PreprocessConfig(),
    frozen_bn: bool = False,
) -> Callable[[Tree, Tree, Dict[str, torch.Tensor]], Tuple[Tree, Dict[str, torch.Tensor], Tree]]:
    """(params, batch_stats, batch) -> (grads, metrics, new batch_stats):
    the loss of `make_train_step` and its gradient with respect to params
    (`jax.value_and_grad(loss_fn, has_aux=True)` of the JAX step).

    batch['image'] is uint8 BGR, normalized here on the device as the
    inference preprocess does (BGR flip, /255, mean/std); a float image
    passes through as it is. `frozen_bn` normalizes with the running
    statistics and returns batch_stats unchanged (the FrozenBN step);
    otherwise BatchNorm takes batch statistics and the new running ones come
    back. `train_cfg.remat` wraps the forward in
    `torch.utils.checkpoint(use_reentrant=False)`, as `jax.checkpoint` wraps
    the JAX step's `_apply`.

    `reduce` (a sum over the ranks, with autograd) and `share` (this rank's
    rows over the global batch's, a device tensor) make it one rank's of a
    data-parallel step (`shard_train_step`): BatchNorm's moments and the
    loss normalizers are then the global batch's, so the loss is this rank's
    share of the global one. BatchNorm takes them through `BatchNorm.sync`
    for the forward and the backward (a recompute under remat included)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    consts: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def normalize(img: torch.Tensor) -> torch.Tensor:
        x = img.float()
        if img.dtype != torch.uint8:
            return x
        if img.device not in consts:  # copied once a device, not every step
            consts[img.device] = tuple(
                torch.tensor(v, dtype=torch.float32).to(img.device) for v in (pre_cfg.mean, pre_cfg.std))
        mean, std = consts[img.device]
        if pre_cfg.bgr_input:
            x = x.flip(-1)
        return (x / 255.0 - mean) / std

    def apply(params: Tree, batch_stats: Tree, x: torch.Tensor):
        out = torch.func.functional_call(
            model, _module_tensors(params, batch_stats), (x,), {"train": not frozen_bn})
        return out, (batch_stats if frozen_bn else _collect_stats(model))

    def loss_and_grads(params: Tree, batch_stats: Tree, batch: Dict[str, torch.Tensor],
                       reduce: Optional[Callable] = None, share: Optional[torch.Tensor] = None):
        paths, leaves = _unzip(params)
        leaves = [x.detach().requires_grad_() for x in leaves]
        for m in bns:
            m.sync = None if reduce is None else (reduce, share)
        try:
            with torch.enable_grad():
                x = normalize(batch["image"])
                if train_cfg.remat:
                    outputs, new_stats = checkpoint(
                        apply, tree_build(paths, leaves), batch_stats, x, use_reentrant=False)
                else:
                    outputs, new_stats = apply(tree_build(paths, leaves), batch_stats, x)
                total, metrics = detection_loss(outputs, batch, train_cfg, reduce)
                grads = torch.autograd.grad(total, leaves)
        finally:
            for m in bns:
                m.sync = None
        # a kernel's gradient comes back as a permuted view of the OIHW one
        grads = [g.contiguous() for g in grads]
        return tree_build(paths, grads), {k: v.detach() for k, v in metrics.items()}, new_stats

    return loss_and_grads


def make_train_step(
    model: CenterFaceNet,
    tx: Optimizer,
    train_cfg: TrainConfig,
    pre_cfg: PreprocessConfig = PreprocessConfig(),
    frozen_bn: bool = False,
) -> Callable[[TrainState, Dict[str, torch.Tensor]], Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """The (state, batch) -> (state, metrics) step (see `make_loss_fn` for
    the batch, `frozen_bn`, and the `reduce` and `share` of one rank's step
    of a data-parallel one, whose gradients and metrics it sums over the
    ranks). The EMA, ema*d + params*(1-d) with d the float32 decay, is
    computed inside the step from the new params."""
    loss_and_grads = make_loss_fn(model, train_cfg, pre_cfg, frozen_bn)
    decay = train_cfg.ema_decay

    @torch.no_grad()
    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   reduce: Optional[Callable] = None, share: Optional[torch.Tensor] = None):
        grads, metrics, new_stats = loss_and_grads(state.params, state.batch_stats, batch, reduce, share)
        if reduce is not None:
            # each rank's loss is its share of the global batch's (the
            # normalizers are global), so the shares' gradients and metrics
            # sum to the global step's; averaging would divide them again
            gpaths, g = _unzip(grads)
            names = sorted(metrics)
            summed = sum_over_ranks(g + [metrics[k] for k in names])
            grads = tree_build(gpaths, summed[: len(g)])
            metrics = dict(zip(names, summed[len(g):]))
        updates, new_opt = tx.update(grads, state.opt_state, state.params)
        paths, params = _unzip(state.params)
        new_p = torch._foreach_add(params, _unzip(updates)[1])
        new_ema = None
        if state.ema_params is not None:
            d = torch.full((), decay, dtype=torch.float32, device=state.step.device)
            new_ema = tree_build(paths, torch._foreach_add(
                torch._foreach_mul(_unzip(state.ema_params)[1], d), torch._foreach_mul(new_p, 1.0 - d)))
        return TrainState(
            params=tree_build(paths, new_p),
            batch_stats=new_stats,
            opt_state=new_opt,
            step=state.step + 1,
            ema_params=new_ema,
        ), metrics

    return train_step


def state_to(state: TrainState, device) -> TrainState:
    """A copy of `state` with every tensor on `device`."""
    dev = torch.device(device)

    def put(tree):
        return None if tree is None else tree_map(lambda t: t.to(dev, copy=True), tree)

    return TrainState(params=put(state.params), batch_stats=put(state.batch_stats), opt_state=put(state.opt_state),
                      step=state.step.to(dev, copy=True), ema_params=put(state.ema_params))


def _mesh_device(mesh: Mesh) -> torch.device:
    if len(mesh.devices) != 1:
        raise ValueError(
            f"data-parallel training runs one process per device, and this process holds {len(mesh.devices)} "
            "devices of the mesh: start one process per device (runtime.sharding.maybe_init_distributed, the "
            "TPUCF_* variables)")
    return mesh.devices[0]


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """A copy of `state` on the mesh's device; in a process group broadcast
    from rank 0, so every replica starts equal."""
    state = state_to(state, _mesh_device(mesh))
    if torch.distributed.is_initialized():
        for t in _state_tensors(state):
            torch.distributed.broadcast(t, src=0)
    return state


def data_parallel_step(train_step, mesh: Mesh):
    """`train_step` (of `make_train_step`) as one rank's step of the
    data-parallel step over `mesh`. It takes this process's rows of the
    global batch (a `ShardedTensor` leaf of `put_sharded` or
    `prefetch_to_device(sharding=)`, or a tensor) on the mesh's device. In a
    process group it hands `train_step` `runtime.sharding.global_sum` and
    this rank's share of the global rows (one all-reduce of the row count a
    step): the BatchNorm moments and the loss normalizers are those of the
    global batch, and the gradients and metrics are summed over the ranks,
    so every rank takes the single-device step on the global batch. Without
    a group it is `train_step` on the mesh's device.

    One process a device: a mesh with several devices in this process raises
    (the step has no in-process reduction over devices)."""
    dev = _mesh_device(mesh)

    def local(x) -> torch.Tensor:
        if isinstance(x, ShardedTensor):
            return x.gather(dev)
        return (x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))).to(dev)

    def step(state: TrainState, batch: Dict[str, Any]):
        rows = {k: local(v) for k, v in batch.items()}
        if not torch.distributed.is_initialized():
            return train_step(state, rows)
        n = torch.full((1,), float(rows["image"].shape[0]), dtype=torch.float32, device=dev)
        total = n.clone()
        torch.distributed.all_reduce(total)
        return train_step(state, rows, global_sum, n / total)

    return step


def shard_train_step(train_step, mesh: Mesh, state: TrainState):
    """(`data_parallel_step(train_step, mesh)`, `replicate_state(state,
    mesh)`): the JAX function's pair of the data-parallel step and the state
    on the mesh."""
    return data_parallel_step(train_step, mesh), replicate_state(state, mesh)


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    trees = [state.params, state.batch_stats, state.opt_state] + ([state.ema_params] if state.ema_params is not None else [])
    return [t for tree in trees for _, t in tree_paths(tree)] + [state.step]


def make_dummy_batch(
    batch: int, size: int, train_cfg: TrainConfig, stride: int = 4, device=None
) -> Dict[str, torch.Tensor]:
    """Tiny synthetic batch with one centered GT box per image (for dry runs)."""
    dev = resolve_device(device)
    h = w = size // stride
    m = train_cfg.max_objs
    hm = torch.zeros((batch, h, w, 1))
    hm[:, h // 2, w // 2, 0] = 1.0
    ind = torch.zeros((batch, m), dtype=torch.int32)
    ind[:, 0] = (h // 2) * w + w // 2
    mask = torch.zeros((batch, m))
    mask[:, 0] = 1.0
    out = {
        "image": torch.zeros((batch, size, size, 3)),
        "hm": hm,
        "ind": ind,
        "mask": mask,
        "wh": torch.ones((batch, m, 2)) * 2.0 * mask[..., None],
        "off": torch.ones((batch, m, 2)) * 0.3 * mask[..., None],
    }
    if train_cfg.with_landmarks:
        out["lm"] = torch.ones((batch, m, 10)) * 0.5 * mask[..., None]
        out["lm_mask"] = mask
    return {k: v.to(dev) for k, v in out.items()}
