"""Double-buffered host -> device prefetch.

Mirrors `tpucenterface/runtime/prefetch.py::prefetch_to_device`. A copy from
pinned host memory with `non_blocking=True` returns before the copy has run,
so the transfers of the next batches overlap the device's work on this one
as long as they are enqueued ahead. This iterator keeps `size` such
transfers in flight. The pinned buffers come from PyTorch's caching host
allocator, which reuses a buffer only after the copy that read it has
completed.

With `sharding=` (a `runtime.sharding.Sharding`, as `batch_sharding(mesh)`
gives it) the iterator yields the global batch on every process, and each
leaf goes on the mesh as `Sharding.put` puts it: this process's rows
(`process_local_batch_bounds`) split over its devices, a `ShardedTensor`.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator, Optional

import numpy as np
import torch

from tpucenterface_torch.config import resolve_device
from tpucenterface_torch.runtime.sharding import Sharding


def _tree_map(fn, item):
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    if isinstance(item, (list, tuple)):
        return type(item)(_tree_map(fn, v) for v in item)
    return fn(item)


def prefetch_to_device(
    iterator: Iterable[Any],
    size: int = 2,
    device=None,
    sharding: Optional[Any] = None,
) -> Iterator[Any]:
    """Yield device-resident trees (dicts, lists and tuples of numpy arrays
    or tensors), keeping `size` transfers in flight. `device`: the GPU
    unless it names another; on a CUDA device each leaf is pinned and copied
    with `non_blocking=True`, elsewhere copied as it is. `sharding` puts
    each leaf on a mesh instead (`device` is then not read)."""
    if sharding is not None and not isinstance(sharding, Sharding):
        raise TypeError(f"sharding must be a runtime.sharding.Sharding (batch_sharding(mesh)), got {sharding!r}")
    if size < 1:
        raise ValueError(f"size must be >= 1, got {size}")
    dev = resolve_device(device) if sharding is None else None

    def put(x):
        if sharding is not None:
            return sharding.put(x)
        t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor) else x)
        if dev.type == "cuda":
            return t.pin_memory().to(dev, non_blocking=True)
        return t.to(dev)

    queue: collections.deque = collections.deque()
    for item in iterator:
        queue.append(_tree_map(put, item))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
