"""Data parallelism over torch.distributed.

Mirrors `tpucenterface/runtime/sharding.py` (`maybe_init_distributed`,
`data_mesh`, `process_local_batch_bounds`, `batch_sharding`, `replicated`,
`shard_batch_fn`, `put_sharded`). The model is small, so data parallelism is
the only parallelism: the weights are replicated, the batch splits over a 1-D
'data' mesh, and inference needs no collective.

Where JAX has one program over a global device set, the port has one process
per rank of a `torch.distributed` process group (NCCL on cards, gloo on the
CPU), each with its own devices:
- `Mesh` is this process's devices, the world size and the rank; `size`
  counts the devices of every rank. A CPU mesh may list the CPU several
  times, so that a batch splits over logical replicas in one process.
- A batch put on a mesh (`put_sharded`, `Sharding.put`) is this process's
  rows of the global batch (`process_local_batch_bounds`), split over its
  devices: a `ShardedTensor`.
- `shard_batch_fn` runs a program on each local device's rows, with no
  collective, and concatenates the results in order on the first device.
  A program that closes over weights on one device takes `program_for`,
  which gives the program of each device (a replica of those weights).
- Training reduces over the ranks inside the step
  (`train.step.shard_train_step`, which hands the step `global_sum` and this
  rank's share of the global rows): the BatchNorm moments, the loss
  normalizers and the gradients are summed over the global batch, as GSPMD
  reduces them in the JAX step.
Nothing falls back to the CPU: without a process group the default mesh is
the cards (and raises where there are none), and a group runs on NCCL unless
the caller names gloo, whose ranks compute on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpucenterface_torch.config import resolve_device

_DISTRIBUTED_INITIALIZED = False


def maybe_init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Join the process group when a multi-process run is asked for, else
    do nothing. Asked for by the arguments or the environment:
    TPUCF_COORDINATOR (host:port of rank 0, or an init URL), TPUCF_NUM_PROCS
    and TPUCF_PROC_ID; or TPUCF_MULTIHOST=1, which reads torch's own
    variables (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK). The
    backend is NCCL unless `backend` names another (gloo: a group on the
    CPU); NCCL without a card raises. Under NCCL the rank takes its card
    (LOCAL_RANK, or the rank modulo the card count). Returns True once a
    group is up (idempotent, also when the caller set one up itself)."""
    global _DISTRIBUTED_INITIALIZED
    if _DISTRIBUTED_INITIALIZED or dist.is_initialized():
        _DISTRIBUTED_INITIALIZED = True
        return True
    coord = coordinator_address or os.environ.get("TPUCF_COORDINATOR")
    nproc = num_processes or (int(os.environ["TPUCF_NUM_PROCS"]) if "TPUCF_NUM_PROCS" in os.environ else None)
    pid = process_id if process_id is not None else (
        int(os.environ["TPUCF_PROC_ID"]) if "TPUCF_PROC_ID" in os.environ else None)
    auto = os.environ.get("TPUCF_MULTIHOST") == "1"
    if coord is None and not auto:
        return False
    backend = backend or "nccl"
    if backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available for an NCCL process group; pass backend='gloo' to run "
                           "the group on the CPU")
    if coord is not None:
        if nproc is None or pid is None:
            raise ValueError("a coordinator needs the number of processes and this process's id "
                             "(num_processes/process_id or TPUCF_NUM_PROCS/TPUCF_PROC_ID)")
        url = coord if "://" in coord else f"tcp://{coord}"
        dist.init_process_group(backend, init_method=url, world_size=nproc, rank=pid)
    else:
        dist.init_process_group(backend, init_method="env://")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    _DISTRIBUTED_INITIALIZED = True
    return True


def _world() -> Tuple[int, int]:
    """(world size, rank) of the process group, (1, 0) without one."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D 'data' mesh: this process's `devices`, in order, and its place
    among the `world_size` processes of the group."""

    devices: Tuple[torch.device, ...]
    world_size: int = 1
    rank: int = 0
    axis_names: Tuple[str, ...] = ("data",)

    @property
    def size(self) -> int:
        """The devices of every rank (each rank holds as many as this one)."""
        return len(self.devices) * self.world_size

    def local(self) -> "Mesh":
        """This process's devices alone, as a one-rank mesh."""
        return Mesh(self.devices)


def data_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """The 'data' mesh over this process's devices and the process group.
    `devices` default: in a process group the rank's own device (its card
    under NCCL, the CPU under gloo); otherwise every card, and where there
    is none it raises (a CPU mesh is asked for by `devices`). `n_devices`
    counts the devices of every rank: in one process it takes the first n;
    across processes it must be the mesh's size."""
    world, rank = _world()
    if devices is None:
        if dist.is_initialized():
            cuda = dist.get_backend() == "nccl"
            devices = [torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")]
        else:
            resolve_device(None)  # raises where there is no card
            devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if n_devices is not None:
        if world == 1:
            if n_devices > len(devices):
                raise ValueError(f"n_devices={n_devices}: this process has {len(devices)} device(s) and no "
                                 "process group (start one process per device, see maybe_init_distributed)")
            devices = devices[:n_devices]
        elif n_devices != len(devices) * world:
            raise ValueError(f"n_devices={n_devices}: the process group spans {len(devices) * world} devices")
    return Mesh(devices, world, rank)


def _bounds(global_batch: int, n: int, i: int) -> Tuple[int, int]:
    per = global_batch // n
    return (i * per, (i + 1) * per if i < n - 1 else global_batch)


def process_local_batch_bounds(global_batch: int) -> tuple:
    """[start, end) rows of the global batch this process feeds ((0, B) in
    one process; the last rank takes the remainder)."""
    return _bounds(global_batch, *_world())


class ShardedTensor:
    """A process's share of a batch on a mesh: `shards[k]` on the mesh's k-th
    local device, in row order, or the same whole tensor on each device when
    `replicated`."""

    def __init__(self, shards: Sequence[torch.Tensor], replicated: bool = False):
        self.shards = tuple(shards)
        self.replicated = replicated

    @property
    def shape(self) -> torch.Size:
        rows = self.shards[0].shape[0] if self.replicated else sum(s.shape[0] for s in self.shards)
        return torch.Size((rows, *self.shards[0].shape[1:]))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(s.device for s in self.shards)

    def gather(self, device=None) -> torch.Tensor:
        """The rows as one tensor on `device` (default: the first shard's)."""
        dev = self.shards[0].device if device is None else torch.device(device)
        if self.replicated or len(self.shards) == 1:
            return self.shards[0].to(dev)
        return torch.cat([s.to(dev) for s in self.shards])

    def numpy(self) -> np.ndarray:
        return self.gather("cpu").numpy()


def _to(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _split(t: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """`t`'s rows in equal parts, one on each of the mesh's local devices."""
    n = len(mesh.devices)
    if t.shape[0] % n:
        raise ValueError(f"{t.shape[0]} rows do not divide over the {n} local devices of the mesh")
    return tuple(_to(p, d) for p, d in zip(t.split(t.shape[0] // n), mesh.devices))


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a mesh puts a leaf: split over 'data' (`spec` ("data",)) or
    replicated (`spec` ())."""

    mesh: Mesh
    spec: Tuple[str, ...] = ("data",)

    def put(self, x) -> ShardedTensor:
        """A host leaf (numpy or tensor, the global batch) on the mesh: this
        process's rows split over its devices, or the whole leaf on each."""
        t, mesh = _tensor(x), self.mesh
        if not self.spec:
            return ShardedTensor([_to(t, d) for d in mesh.devices], replicated=True)
        lo, hi = _bounds(t.shape[0], mesh.world_size, mesh.rank)
        return ShardedTensor(_split(t[lo:hi], mesh))


def batch_sharding(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ("data",))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def put_sharded(batch: Any, mesh: Mesh) -> Any:
    """A host batch tree (the global batch) on the mesh, split over 'data'."""
    return _tree_map(batch_sharding(mesh).put, batch)


def _local_shards(x, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    if isinstance(x, ShardedTensor):
        if x.replicated or len(x.shards) != len(mesh.devices):
            raise ValueError(f"a batch argument must be split over the mesh's {len(mesh.devices)} local devices")
        return x.shards
    return _split(_tensor(x), mesh)


def _concat(outs: Sequence[Any], device: torch.device):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _concat([o[k] for o in outs], device) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_concat([o[i] for o in outs], device) for i in range(len(first)))
    if len(outs) == 1:
        return first
    return torch.cat([o.to(device) for o in outs])


def shard_batch_fn(
    fn: Callable,
    mesh: Mesh,
    num_batch_args: int = 1,
    program_for: Optional[Callable[[torch.device], Callable]] = None,
) -> Callable:
    """`fn` run data-parallel over the mesh's local devices: its first
    `num_batch_args` arguments (`ShardedTensor`s of `put_sharded`, or host
    or device batches, split here) go to each device by rows, the program
    runs once on each device's rows with the other arguments as they are,
    and each output (tensors, or tuples, lists and dicts of them) comes back
    as the devices' results concatenated in order on the first device. No
    collective: across processes each rank computes its own rows.
    `program_for(device)` gives the program of a device; by default `fn`
    runs on every device, which suits a function whose only tensors are its
    arguments."""

    def run(*args):
        parts = [_local_shards(a, mesh) for a in args[:num_batch_args]]
        rest = args[num_batch_args:]
        outs = []
        for k, dev in enumerate(mesh.devices):
            prog = fn if program_for is None else program_for(dev)
            outs.append(prog(*(p[k] for p in parts), *rest))
        return _concat(outs, mesh.devices[0])

    return run


# --------------------------------------------------------------------------- #
# reductions over the ranks of a data-parallel train step
# --------------------------------------------------------------------------- #


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks of the process group, with autograd (its
    gradient is the upstream gradients summed over the ranks)."""
    from torch.distributed.nn.functional import all_reduce

    with warnings.catch_warnings():
        # deprecated in favour of the functional collectives, which have no
        # autograd for all_reduce; this one still differentiates
        warnings.simplefilter("ignore", FutureWarning)
        return all_reduce(t)


def sum_over_ranks(tensors: Sequence[torch.Tensor]) -> list:
    """The tensors summed over the ranks of the process group, in one
    all-reduce of one flat buffer (no autograd)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    out, o = [], 0
    for t in tensors:
        out.append(flat[o : o + t.numel()].view_as(t))
        o += t.numel()
    return out
