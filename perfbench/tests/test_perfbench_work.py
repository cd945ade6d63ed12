"""The yardstick's counts: `work.py` against torch's flop counter."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import registry, work
from perfbench.reference.model import to_device
from perfbench.tests.pb_helpers import ROOT, cpu
from perfbench.weights import make_variables

CONFIGS = ["centerface-mbv2", "mbv2x1.4-fpn48"]


def config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("size", [64, 96, 160])
def test_forward_flops_equal_the_flop_counter_on_the_reference(name, size):
    cfg = config(name)
    net = registry.reference(cfg).Network(cfg, to_device(make_variables(cfg, 3, cpu()), "cpu"))
    with FlopCounterMode(display=False) as fc:
        net(torch.zeros(1, 3, size, size))
    assert fc.get_total_flops() == work.forward_flops(cfg, size)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_equal_the_flop_counter_on_the_port(name):
    """The port's module forward, unfolded with separate heads, computes the
    same operations: the count does not depend on who computes them."""
    from tpucenterface_torch.model.centernet import load_network

    cfg = config(name)
    dc = registry.program(cfg).detector_config(cfg)
    model = dc.model.__class__(**{**dc.model.__dict__, "compute_dtype": "float32"})
    net = load_network(make_variables(cfg, 3, cpu()), model, torch.device("cpu"))
    with FlopCounterMode(display=False) as fc:
        net(torch.zeros(1, 96, 96, 3))
    assert fc.get_total_flops() == work.forward_flops(cfg, 96)


def test_forward_gflop_at_640():
    """4.98 GFLOP an image for CenterFace (1x1 heads on the 24-channel neck),
    13.57 for the wider model with its 3x3 head convs."""
    assert work.forward_flops(config("centerface-mbv2"), 640) == 4_981_657_600
    assert work.forward_flops(config("mbv2x1.4-fpn48"), 640) == 13_570_752_000


@pytest.mark.parametrize("name", CONFIGS)
def test_stride1_blocks_are_the_networks(name):
    cfg = config(name)
    got = work.stride1_blocks(cfg, 640, 640, 1)
    assert [b.index for b in got] == [0, 2, 4, 5, 7, 8, 9, 10, 11, 12, 14, 15, 16]
    assert [b.index for b in got] == [i for i, b in enumerate(registry.reference(cfg).blocks(cfg)) if b.stride == 1]


def test_stride1_block_work_by_hand():
    """Block 2 of centerface-mbv2 at 640 (24 -> 144 -> 24 on 160x160), one
    image; a 640 x 512 input halves nothing but the map's width."""
    (b,) = [b for b in work.stride1_blocks(config("centerface-mbv2"), 640, 640, 1) if b.index == 2]
    pos = 160 * 160
    assert b.flops == 2 * pos * (24 * 144 + 9 * 144 + 144 * 24)
    assert b.bytes == 2 * (pos * 48 + 24 * 144 + 9 * 144 + 144 * 24 + 2 * 144 + 24)
    assert b.floor_s() == max(b.flops / 989e12, b.bytes / 3.35e12)
    (c,) = [b for b in work.stride1_blocks(config("centerface-mbv2"), 640, 512, 3) if b.index == 2]
    assert c.flops == 3 * b.flops * 128 // 160
