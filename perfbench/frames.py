"""Painted scenes from the seed, made on the device in bulk.

A frame is a noisy vertical gradient between two colours with cartoon faces
on it: a skin-toned ellipse (aspect 0.68-0.82, heights log-uniform from 24
pixels to 0.4 of the frame's shorter side), two eyes, brows and a mouth. The
faces of a frame may overlap. Frames come back as uint8 BGR numpy arrays.

The work a call asks for depends on the frames' sizes and counts alone;
`sizes` and `face_counts` give every seed the same multiset of both, in an
order drawn from the seed.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

_SKIN_BGR = ((90, 130, 190), (120, 160, 220), (60, 100, 160), (140, 180, 230), (40, 70, 120))


def sizes(n: int, heights: Tuple[int, int], widths: Tuple[int, int], gen: torch.Generator) -> List[Tuple[int, int]]:
    """`n` (h, w): evenly spaced quantiles of the uniform ranges, paired
    and ordered by the seed's permutations."""
    q = (np.arange(n) + 0.5) / n
    hs = np.rint(heights[0] + (heights[1] - heights[0]) * q).astype(int)
    ws = np.rint(widths[0] + (widths[1] - widths[0]) * q).astype(int)
    ph = torch.randperm(n, generator=gen, device=gen.device).cpu().numpy()
    pw = torch.randperm(n, generator=gen, device=gen.device).cpu().numpy()
    return [(int(hs[a]), int(ws[b])) for a, b in zip(ph, pw)]


def face_counts(n: int, faces: Tuple[int, int], gen: torch.Generator) -> np.ndarray:
    """`n` face counts cycling over faces[0]..faces[1], in the seed's order."""
    base = np.resize(np.arange(faces[0], faces[1] + 1), n)
    return base[torch.randperm(n, generator=gen, device=gen.device).cpu().numpy()]


def _ellipse(canvas, inside, color):
    """Paint `color` (N, 3) where `inside` (N, H, W) holds."""
    return torch.where(inside[..., None], color[:, None, None, :], canvas)


def paint(hw: Sequence[Tuple[int, int]], counts: Sequence[int], gen: torch.Generator,
          chunk: int = 32) -> List[np.ndarray]:
    """Frames of the given (h, w) and face counts, painted on `gen`'s
    device in chunks of `chunk` frames of one canvas."""
    dev = gen.device
    out: List[np.ndarray] = []
    for c0 in range(0, len(hw), chunk):
        part, cnt = list(hw[c0:c0 + chunk]), list(counts[c0:c0 + chunk])
        n = len(part)
        H, W = max(h for h, _ in part), max(w for _, w in part)
        h = torch.tensor([p[0] for p in part], device=dev, dtype=torch.float32)
        w = torch.tensor([p[1] for p in part], device=dev, dtype=torch.float32)
        u = lambda *shape: torch.rand(*shape, generator=gen, device=dev)  # noqa: E731
        g0, g1 = 20 + 140 * u(n, 3), 20 + 140 * u(n, 3)
        ys = torch.arange(H, device=dev, dtype=torch.float32)[None, :, None]
        xs = torch.arange(W, device=dev, dtype=torch.float32)[None, None, :]
        ramp = (ys / (h[:, None, None] - 1).clamp_min(1)).clamp(0, 1)[..., None]
        img = g0[:, None, None] * (1 - ramp) + g1[:, None, None] * ramp
        img = img + 6 * torch.randn(n, H, W, 3, generator=gen, device=dev)
        skin = torch.tensor(_SKIN_BGR, device=dev, dtype=torch.float32)
        short = torch.minimum(h, w)
        for j in range(max(cnt)):
            on = torch.tensor([j < c for c in cnt], device=dev)
            size = torch.exp(np.log(24.0) + u(n) * (torch.log(0.4 * short) - np.log(24.0)))
            h2 = size / 2
            w2 = h2 * (0.68 + 0.14 * u(n))
            cx = w2 + 2 + u(n) * (w - 2 * w2 - 4).clamp_min(0)
            cy = h2 + 2 + u(n) * (h - 2 * h2 - 4).clamp_min(0)
            tone = (skin[torch.randint(len(_SKIN_BGR), (n,), generator=gen, device=dev)]
                    * (0.85 + 0.3 * u(n, 3))).clamp(0, 255)
            dark = 10 + 50 * u(n, 3)

            def inside(ex, ey, rx, ry):
                return on[:, None, None] & (((xs - ex[:, None, None]) / rx[:, None, None]) ** 2
                                            + ((ys - ey[:, None, None]) / ry[:, None, None]) ** 2 <= 1)

            img = _ellipse(img, inside(cx, cy, w2, h2), tone)
            er = (0.11 * h2).clamp_min(1)
            for sx in (-0.38, 0.38):
                ex, ey = cx + sx * w2, cy - 0.18 * h2
                img = _ellipse(img, inside(ex, ey, er, er * 0.62), (tone * 1.35 + 40).clamp(0, 255))
                img = _ellipse(img, inside(ex, ey, er * 0.5, er * 0.5), dark)
                img = _ellipse(img, inside(ex, cy - 0.38 * h2, er, (er * 0.3).clamp_min(1)), dark * 0.8)
            mouth = torch.stack([30 + 40 * u(n), 20 + 40 * u(n), 90 + 90 * u(n)], -1)
            img = _ellipse(img, inside(cx, cy + 0.48 * h2, 0.26 * h2, (0.07 * h2).clamp_min(1)), mouth)
        img = img.clamp(0, 255).to(torch.uint8).cpu().numpy()
        out += [np.ascontiguousarray(img[i, :hh, :ww]) for i, (hh, ww) in enumerate(part)]
    return out
