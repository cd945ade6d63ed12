"""The inputs and weights are made from the seed."""

import json

import numpy as np
import torch

from perfbench import frames
from perfbench.tests.pb_helpers import ROOT, cpu
from perfbench.weights import make_variables

CFG = json.loads((ROOT / "perfbench" / "configs" / "centerface-mbv2.json").read_text())
BIG = 2**31 + 977


def leaves(tree):
    for v in tree.values():
        yield from (leaves(v) if isinstance(v, dict) else [v])


def painted(seed):
    gen = torch.Generator(cpu()).manual_seed(seed)
    hw = frames.sizes(6, (90, 220), (160, 160), gen)
    return hw, frames.paint(hw, frames.face_counts(6, (2, 8), gen), gen)


def test_weights_are_the_seeds():
    a, b, c = (make_variables(CFG, s, cpu()) for s in (BIG, BIG, BIG + 1))
    assert all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(b)))
    assert not all(np.array_equal(x, y) for x, y in zip(leaves(a), leaves(c)))
    assert np.isfinite(a["params"]["heads"]["hm"]["out"]["bias"]).all()


def test_frames_are_the_seeds():
    (hw1, f1), (hw2, f2), (hw3, f3) = painted(BIG), painted(BIG), painted(BIG + 1)
    assert hw1 == hw2 and all(np.array_equal(x, y) for x, y in zip(f1, f2))
    assert not all(x.shape == y.shape and np.array_equal(x, y) for x, y in zip(f1, f3))
    assert all(f.dtype == np.uint8 and f.shape == (h, w, 3) for f, (h, w) in zip(f1, hw1))


def test_every_seed_gets_the_same_sizes_and_face_counts():
    """Only the order of the work differs from seed to seed."""
    a, b = painted(5)[0], painted(6)[0]
    assert sorted(a) == sorted(b) and a != b
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(6)
    assert sorted(frames.face_counts(32, (2, 8), g1)) == sorted(frames.face_counts(32, (2, 8), g2))
