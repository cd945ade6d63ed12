"""Video, webcam or image-directory demo: pipelined detection, boxes and fps.

    python -m tpucenterface_torch.cli.demo --source video.mp4 --weights w.pth --out out.mp4

Mirrors `tpucenterface/cli/demo.py`, with the same arguments and `--device`
(the GPU unless it names another). Frames go through the port's
`runtime.video.VideoPipeline`. Headless by default: the drawn frames are
written to `--out` (an mp4) or shown with `--show`, and only then drawn, so
`--source synthetic` without either runs without `cv2`, which is imported
only to read a source or to draw and write. The fps are the demo's own count
of frames over wall time since the run began: the pipeline's `last_fps` is
set only when a run is drained to its end, which `--max-frames` cuts short.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _frames(source: str):
    if source == "synthetic":
        rng = np.random.RandomState(0)
        for _ in range(120):
            yield rng.randint(0, 255, (720, 1280, 3), np.uint8)
        return
    import cv2

    if os.path.isdir(source):
        for name in sorted(os.listdir(source)):
            img = cv2.imread(os.path.join(source, name))
            if img is not None:
                yield img
        return
    cap = cv2.VideoCapture(0 if source == "webcam" else source)
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            yield frame
    finally:
        cap.release()


def main(argv=None):
    p = argparse.ArgumentParser(description="tpucenterface demo")
    p.add_argument("--source", default="synthetic",
                   help="video file, image dir, 'webcam', or 'synthetic'")
    p.add_argument("--weights", default=None, help=".safetensors or torch .pth")
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--thresh", type=float, default=0.35)
    p.add_argument("--out", default=None, help="output video path (mp4)")
    p.add_argument("--show", action="store_true")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = p.parse_args(argv)

    from tpucenterface_torch.cli.serve import load_detector
    from tpucenterface_torch.runtime.video import VideoPipeline, draw_detections

    det = load_detector(args.weights, args.device, "demo")
    pipe = VideoPipeline(det, size=args.size)
    writer = None
    n = 0
    t0 = time.perf_counter()
    fps = 0.0
    try:
        for frame, boxes, scores in pipe.run(_frames(args.source), score_thresh=args.thresh):
            n += 1
            fps = n / (time.perf_counter() - t0)
            if args.out or args.show:
                import cv2

                vis = draw_detections(frame, boxes, scores)
                cv2.putText(vis, f"{fps:.1f} fps", (8, 24),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.8, (0, 0, 255), 2)
                if args.out:
                    if writer is None:
                        writer = cv2.VideoWriter(
                            args.out, cv2.VideoWriter_fourcc(*"mp4v"), 25, (vis.shape[1], vis.shape[0]))
                    writer.write(vis)
                if args.show:
                    cv2.imshow("tpucenterface", vis)
                    if cv2.waitKey(1) == 27:
                        break
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        if writer is not None:
            writer.release()
    lat = np.median(pipe.steady_latencies_ms) if pipe.steady_latencies_ms else 0
    print(f"[demo] {n} frames, {fps:.1f} fps, p50 latency {lat:.1f} ms")


if __name__ == "__main__":
    main()
