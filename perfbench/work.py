"""The yardstick's arithmetic: operations and bytes from shapes, and the
card's data-sheet peaks.

Work is counted from what the model computes at a given input, never from
which kernel computed it: a convolution is 2 x its multiply-adds (a
depthwise one too), a head's 1x1 out conv likewise; additions, activations,
the upsample and the decode count none. So two implementations of one model
read the same operations, and a share of a peak moves with time only. What
a forward computes is its architecture's to count (`reference/<arch>.py`'s
`forward_flops` and `stride1_blocks`), which the configuration names.
"""

from __future__ import annotations

from typing import List, NamedTuple

from perfbench import registry

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2


def map_side(n: int, stride: int) -> int:
    """Rows of a map after a 3x3 / stride-2 conv with padding 1, `stride` / 2 times."""
    while stride > 1:
        n, stride = -(-n // 2), stride // 2
    return n


class BlockWork(NamedTuple):
    index: int
    flops: int
    bytes: int

    def floor_s(self) -> float:
        """The least time the card could take: operations at the bf16 peak
        or bytes at the HBM rate, the larger."""
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_HBM_BYTES)


def forward_flops(cfg: dict, size: int) -> int:
    """Operations of one forward of one size x size input."""
    return registry.reference(cfg).forward_flops(cfg, size)


def stride1_blocks(cfg: dict, height: int, width: int, rows: int) -> List[BlockWork]:
    """The blocks of a forward of `rows` inputs of height x width that a
    block kernel may take, in the network's order, with the work of each."""
    return registry.reference(cfg).stride1_blocks(cfg, height, width, rows)
