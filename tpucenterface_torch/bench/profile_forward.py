"""Per-section device time of the detect path's module forward (bs32 @ 640).

Mirrors `tpucenterface/bench/profile_forward.py::profile`: the preprocess,
the stem, every backbone block, the neck, the heads and the decode, each
timed in isolation with `bench.timing.op_time_ms` on random inputs of its
shapes, then the whole forward and the whole detect program as cross-checks
(sections timed alone leave out what runs between them, and a section's
first launch may wait less behind another's, so the whole can differ from
the sum). The modules are the Detector's own network (random weights from
seed 0), called as its forward calls them: NCHW in the channels_last memory
format, in the compute dtype.

Usage: python -m tpucenterface_torch.bench.profile_forward [--batch 32] [--size 640] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpucenterface_torch.bench.timing import op_time_ms
from tpucenterface_torch.config import DetectorConfig, dtype_of
from tpucenterface_torch.detector import Detector
from tpucenterface_torch.model.backbone import backbone_plan, space_to_depth
from tpucenterface_torch.preprocess import letterbox_normalize_batch


def profile(batch: int = 32, size: int = 640, k_pair=(2, 8), only: str = "", device=None) -> dict:
    """{row name: ms} of every section (and the two cross-checks), printed as
    they are timed; `only` times the rows whose name contains it."""
    det = Detector(config=DetectorConfig(), device=device)
    mcfg = det.config.model
    net, dev = det.model, det.device
    dtype = dtype_of(mcfg.compute_dtype)
    rows = {}
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, dt=dtype, nchw=True):
        """Uniform [0, 1): NCHW features in the channels_last memory format,
        or (nchw=False) a contiguous NHWC tensor."""
        t = torch.rand(shape, generator=gen).to(device=dev, dtype=dt)
        return t.contiguous(memory_format=torch.channels_last) if nchw else t

    def tm(name, fn, *args):
        if only and only not in name:
            return 0.0
        ms = op_time_ms(fn, *args, k_pair=k_pair)
        rows[name] = ms
        print(f"{name:28s} {ms:8.3f} ms", flush=True)
        return ms

    with torch.inference_mode():
        # --- preprocess ---------------------------------------------------
        rng = np.random.RandomState(0)
        imgs = torch.from_numpy(rng.randint(0, 255, (batch, size, size, 3), np.uint8)).to(dev)
        hws = torch.tensor([[size, size]] * batch, dtype=torch.int32, device=dev)
        pp, raw = det.config.preprocess, mcfg.stem_preprocess
        tm("preprocess", lambda im: letterbox_normalize_batch(im, hws, size, pp, raw=raw)[0], imgs)

        # --- stem ---------------------------------------------------------
        s = size // 2
        x_in = rand(batch, 3, size, size)
        stem_c = mcfg.width(mcfg.stem_channels)
        if mcfg.s2d_stem:
            tm("stem(s2d) @%d->%dx%d" % (size, s, stem_c), lambda x: net.backbone.stem(space_to_depth(x)), x_in)
        else:
            tm("stem  @%d->%dx%d" % (size, s, stem_c), net.backbone.stem, x_in)

        # --- every backbone block in isolation ----------------------------
        plan = backbone_plan(mcfg)
        in_ch, res = stem_c, s
        total_blocks = 0.0
        strides_map = {}
        for i, (t, c, st, out_stride) in enumerate(plan):
            blk = getattr(net.backbone, f"block_{i}")
            total_blocks += tm(f"block_{i:<2d} t{t} {in_ch:>3d}->{c:<3d} s{st} @{res}", blk, rand(batch, in_ch, res, res))
            res //= st
            in_ch = c
            strides_map[out_stride] = (res, c)

        # --- neck ---------------------------------------------------------
        feats = {k: rand(batch, c, r, r) for k, (r, c) in strides_map.items() if k in (4, 8, 16, 32)}
        tm("neck", net.neck, feats)

        # --- heads --------------------------------------------------------
        r4, _ = strides_map[4]
        tm("heads", net.heads, rand(batch, mcfg.fpn_channels, r4, r4))

        # --- decode -------------------------------------------------------
        wh, off, hm = (rand(batch, r4, r4, c, dt=torch.float32, nchw=False) for c in (2, 2, 1))
        tm("decode", lambda hm: det._decode({"hm": hm, "wh": wh, "off": off})[:2], hm)

        # --- cross-checks -------------------------------------------------
        tm("FULL forward", det._forward, rand(batch, size, size, 3, dt=torch.float32, nchw=False))
        fn = det._batch_fn(batch, (size, size), size)
        tm("FULL detect (pp+fwd+dec)", lambda im: fn(im, hws), imgs)
    print(f"{'sum of blocks':28s} {total_blocks:8.3f} ms")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--only", type=str, default="")
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args()
    dev = torch.device(args.device or "cuda")
    print(f"device={dev} {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}")
    profile(args.batch, args.size, only=args.only, device=args.device)
