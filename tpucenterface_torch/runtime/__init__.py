"""Runtime: host -> device prefetch, dynamic-batching serving, video
streaming and profiling.

Mirrors `tpucenterface/runtime/` but for `sharding.py` (`data_mesh`,
`shard_batch_fn`): data-parallel serving and the multi-host input feed come
with the torch.distributed port (ROADMAP.md, A9).
"""

from tpucenterface_torch.runtime.prefetch import prefetch_to_device

__all__ = ["prefetch_to_device"]
