"""The yardstick's arithmetic: operations and bytes from shapes, and the
card's data-sheet peaks.

Work is counted from what the model computes at a given input, never from
which kernel computed it: a convolution is 2 x its multiply-adds (a
depthwise one too), a head's 1x1 out conv likewise; additions, activations,
the upsample and the decode count none. So two implementations of one model
read the same operations, and a share of a peak moves with time only.
"""

from __future__ import annotations

from typing import List, NamedTuple

from perfbench.reference.model import blocks, feature_blocks, head_outputs, stem_channels

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2


def _down(n: int, stride: int) -> int:
    """Rows of a map after a 3x3 / stride-2 conv with padding 1, `stride` / 2 times."""
    while stride > 1:
        n, stride = -(-n // 2), stride // 2
    return n


def forward_flops(cfg: dict, size: int) -> int:
    """Operations of one forward of one size x size input."""
    hw = lambda s: _down(size, s) ** 2  # noqa: E731  cells of the map at stride s
    f = 2 * hw(2) * 3 * 9 * stem_channels(cfg)
    for b in blocks(cfg):
        hidden = b.cin * b.expand
        if b.expand != 1:
            f += 2 * hw(b.in_stride) * b.cin * hidden
        f += 2 * hw(b.out_stride) * hidden * 9
        f += 2 * hw(b.out_stride) * hidden * b.cout
    c = cfg["fpn_channels"]
    bl = blocks(cfg)
    feats = feature_blocks(cfg)
    for s, i in feats.items():
        f += 2 * hw(s) * bl[i].cout * c
    for s in sorted(feats)[:-1]:
        f += 2 * hw(s) * c * c * 9
    hc = cfg["head_conv"]
    for _, n in head_outputs(cfg):
        f += 2 * hw(4) * (c * hc * 9 + hc * n if hc else c * n)
    return f


class BlockWork(NamedTuple):
    index: int
    flops: int
    bytes: int

    def floor_s(self) -> float:
        """The least time the card could take: operations at the bf16 peak
        or bytes at the HBM rate, the larger."""
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_HBM_BYTES)


def stride1_blocks(cfg: dict, height: int, width: int, rows: int) -> List[BlockWork]:
    """The stride-1 inverted residual blocks of a forward of `rows` inputs
    of height x width, in the network's order, and the work of each:
    operations, the expand's and the project's products and the depthwise's
    nine multiply-adds a value; bytes, the input and output maps once and
    the weights and biases once, all in bf16. Which of them a kernel took is
    for the trace to say (`metrics/mbconv_roofline.py`), not for this
    count."""
    out = []
    for i, b in enumerate(blocks(cfg)):
        if b.stride != 1:
            continue
        pos = rows * _down(height, b.in_stride) * _down(width, b.in_stride)
        ce = b.cin * b.expand
        ex = b.cin * ce if b.expand != 1 else 0
        flops = 2 * pos * (ex + 9 * ce + ce * b.cout)
        weights = ex + 9 * ce + ce * b.cout + (2 * ce if b.expand != 1 else ce) + b.cout
        out.append(BlockWork(i, flops, BF16_BYTES * (pos * (b.cin + b.cout) + weights)))
    return out
