"""Runtime: data-parallel sharding over torch.distributed, host -> device
prefetch, dynamic-batching serving, video streaming and profiling.

Mirrors `tpucenterface/runtime/`.
"""

from tpucenterface_torch.runtime.prefetch import prefetch_to_device
from tpucenterface_torch.runtime.sharding import data_mesh, shard_batch_fn

__all__ = ["data_mesh", "shard_batch_fn", "prefetch_to_device"]
