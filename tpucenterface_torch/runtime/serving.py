"""Dynamic-batching serving engine: coalesce detect requests into large
device batches.

Mirrors `tpucenterface/runtime/serving.py` (`_resolve`, `_Request`,
`ServingEngine`, `ServingRouter`) with the same arguments, defaults,
validation, messages and semantics. With `mesh=` (a `runtime.sharding.Mesh`)
each launch runs data-parallel over this process's devices of the mesh
(`shard_batch_fn`), with launch sizes that divide over the mesh's `size`, as
in JAX; each process serves the requests submitted to it.

A detector's batch program costs less an image at a large batch than at a
small one, so the engine admits requests of any batch size, coalesces them
into one launch of up to `device_batch` images, runs ONE program and scatters
the per-request results back.

Two operating modes:
- `ServingEngine.submit(images)`: thread-safe, returns a Future; a background
  worker drains the queue, coalescing up to `device_batch` images a launch.
  Launch and fetch are pipelined: up to `inflight` launched groups stay
  unfetched, so the device runs group N+1 while the host splits group N's
  results. Only the fetch (`_finalize`) waits for the device: a launch
  stages its inputs and enqueues its program without a host sync (with the
  pinned staging, see `staging`), and a CUDA error that surfaces at the
  fetch fails that group alone.
- `ServingEngine.map_stream(batches)`: a synchronous helper for offline
  sweeps: coalesces an iterator of (B_i, H, W, 3) request batches and yields
  per-request results in order, with the same pipelined fetch.

All requests in one engine share one padded input shape (the engine is
per-bucket, like the Detector's program cache); mixed-shape streams go
through `ServingRouter`, which pads each image to its input bucket and
routes it to a per-bucket engine.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Any, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from tpucenterface_torch import native
from tpucenterface_torch.detector import Detections, Detector, stage_inputs
from tpucenterface_torch.preprocess import pad_to_bucket
from tpucenterface_torch.runtime.sharding import Mesh, put_sharded, shard_batch_fn


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a runtime.sharding.Mesh (data_mesh()), got {mesh!r}")


def _resolve(fut: Future, result=None, exc=None) -> None:
    """set_result/set_exception tolerating a client cancel() racing in
    between any 'cancelled()' check and the set: these futures are never
    set_running_or_notify_cancel()'d, so cancel() can succeed right up to
    the set, and an InvalidStateError here must not abort resolving the rest
    of a coalesced group (their callers would block forever)."""
    try:
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:  # client cancelled: drop the result
        pass


class _Request:
    __slots__ = ("images", "hws", "future", "n", "t_submit")

    def __init__(self, images: np.ndarray, hws: np.ndarray):
        self.images = images
        self.hws = hws
        self.n = images.shape[0]
        self.future: Future = Future()
        self.t_submit = time.perf_counter()


class ServingEngine:
    """Coalescing executor over one Detector and one input bucket.

    Args:
      detector: the Detector whose batch programs serve the requests.
      padded_hw: the (H, W) every request's images are already padded to
        (one program per padded shape, as in Detector._batch_fn).
      device_batch: target device batch a launch; requests coalesce up to
        this many images.
      size: model input size (defaults to the detector's default size).
      score_thresh: threshold applied to the fixed-K results per request.
      inflight: how many launched but unfetched groups to keep (2 = double
        buffering; the device runs launches in order, so deeper adds
        latency, not throughput).
      batch_ladder: the padded launch sizes available. Every launch pads its
        coalesced total up to the smallest rung that fits (the biggest rung
        is `device_batch`), so a lone low-load request rides a small program
        instead of paying for the full `device_batch` one. None (default)
        builds {device_batch//4, device_batch}; (device_batch,) keeps one
        launch size.
      max_dets: serving decode profile: caps the per-image top-K below the
        detector's configured K (DecodeConfig.max_dets); None keeps it.
      staging: how a launch's uint8 batch reaches the device:
        - "formatted" (default): the staging format of the program's launch
          signature (`Detector._batch_fn_auto`): on a CUDA device the batch
          is assembled into a reused pinned host buffer and copied on a copy
          stream, so the copy of launch N+1 runs beside program N and the
          worker never waits for the device to launch. `stats()` counts these
          launches as `pinned_launches`.
        - "plain": the pageable `.to(device)` copy of `detect_batch`, on the
          compute stream: the copy of launch N+1 queues behind program N, and
          the worker waits for it.
        On the CPU both are the same call: there is no transfer to stage.
      int8_input: host-quantized staging (needs a quantize()d detector with
        the stem-baked preprocess). Identity launches apply the stem's uint8
        -> int8 table while the launch buffer is assembled (the threaded C++
        kernel of `tpucenterface_torch.native`) and run the int8-input
        program, which skips the device's input quantize. Its input takes
        the pageable copy, as in the JAX package. Letterbox (non-identity)
        launches fall back to the uint8 program.
      mesh: optional 1-D 'data' `runtime.sharding.Mesh`: launches run
        data-parallel over this process's devices of it, each device on its
        rows of the launch (`shard_batch_fn`; a device other than the
        detector's runs a `Detector.replica`, both keyed on
        `weights_version`, so a swap never serves old weights). device_batch
        and every ladder rung must divide over the mesh's size, the default
        small rung and a request larger than device_batch are rounded up to
        it. DP launches stage plainly (`put_sharded`).
    """

    def __init__(
        self,
        detector: Detector,
        padded_hw: Tuple[int, int],
        device_batch: int = 128,
        size: Optional[int] = None,
        score_thresh: Optional[float] = None,
        inflight: int = 2,
        mesh=None,
        batch_ladder: Optional[Sequence[int]] = None,
        max_dets: Optional[int] = None,
        int8_input: bool = False,
        staging: str = "formatted",
    ):
        _check_mesh(mesh)
        if device_batch < 1:
            raise ValueError("device_batch must be >= 1")
        if staging not in ("formatted", "plain"):
            raise ValueError(f"staging must be 'formatted' or 'plain', got {staging!r}")
        self.staging = staging
        self.mesh = mesh
        self._nd = 1 if mesh is None else mesh.size
        if device_batch % self._nd:
            raise ValueError(f"device_batch {device_batch} must divide over the {self._nd}-device mesh")
        if batch_ladder is None:
            # low-load latency rung: a single small request pays for ~1/4 of
            # the device_batch program instead of all of it
            small = -(-max(1, device_batch // 4) // self._nd) * self._nd
            ladder = {small, device_batch}
        else:
            ladder = set(int(b) for b in batch_ladder)
            if max(ladder) != device_batch:
                raise ValueError(f"batch_ladder max {max(ladder)} must equal device_batch {device_batch}")
            if any(b < 1 or b % self._nd for b in ladder):
                raise ValueError(
                    f"every ladder rung must be >=1 and divide over the {self._nd}-device mesh: {sorted(ladder)}")
        self.batch_ladder = tuple(sorted(ladder))
        self.int8_input = bool(int8_input)
        if self.int8_input and not (
            detector.config.model.stem_preprocess and detector.config.preprocess.identity_fast_path
        ):
            # the quantized-detector half of the requirement is checked at
            # launch (quantize() after engine construction is legitimate),
            # but without a stem-baked model AND the identity fast path the
            # int8 staging branch can never run: fail at construction, not
            # silently serve the uint8 program forever
            raise ValueError(
                "int8_input=True requires a stem-baked preprocess model (ModelConfig.stem_preprocess) with "
                "PreprocessConfig.identity_fast_path enabled; this detector can never take the int8 staging path"
            )
        self.max_dets = max_dets
        # data-parallel programs and replicas by (..., weights_version)
        self._dp_cache: dict = {}
        self._replicas: dict = {}
        self.det = detector
        self.padded_hw = tuple(padded_hw)
        self.device_batch = device_batch
        self.size = size or detector.config.default_size
        self.inflight = max(1, inflight)
        self.thresh = detector.config.decode.score_thresh if score_thresh is None else score_thresh
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._map_active = False  # a map_stream() sweep owns the engine
        self._carry: Optional[_Request] = None  # overflow from _coalesce
        self._closed = False
        self._lock = threading.Lock()
        # observability: per-request submit->result latency (last 1024),
        # request/image/launch counters, all mutated under _stats_lock:
        # stats() may be called from a monitoring thread while the worker
        # (or a map_stream caller) appends
        self._stats_lock = threading.Lock()
        self._lat_ms: collections.deque = collections.deque(maxlen=1024)
        self._n_requests = 0
        self._n_images = 0
        self._n_launches = 0
        self._n_pad_images = 0  # padded (wasted) rows summed over launches
        self._n_pinned = 0  # launches staged through pinned host buffers

    # ------------------------------------------------------------------ #
    # core: launch one coalesced group / fetch its results
    # ------------------------------------------------------------------ #

    def _fn(self, batch: int, identity: bool = False, int8_in: bool = False):
        """-> (program, staging format or None) for one launch size."""
        if self.mesh is not None:
            return self._dp_fn(batch, identity, int8_in), None
        if self.staging == "plain":
            fn = self.det._batch_fn(
                batch, self.padded_hw, self.size, identity=identity, max_dets=self.max_dets, int8_in=int8_in,
            )
            return fn, None
        return self.det._batch_fn_auto(
            batch, self.padded_hw, self.size, identity=identity, max_dets=self.max_dets, int8_in=int8_in,
            slots=self.inflight + 1,
        )

    def _dp_fn(self, batch: int, identity: bool, int8_in: bool):
        """The data-parallel program of a launch size: each local device of
        the mesh runs the batch program on its rows, the detector's own on
        its device and a replica's on another. Cached by weights_version,
        entries of older versions dropped on a miss, so a swap never serves
        old weights and rolling reloads do not pile up programs."""
        ver = self.det.weights_version
        key = (batch, identity, int8_in, ver)
        wrapped = self._dp_cache.get(key)
        if wrapped is None:
            for k in [k for k in self._dp_cache if k[3] != ver]:
                del self._dp_cache[k]
            for k in [k for k in self._replicas if k[1] != ver]:
                del self._replicas[k]
            local = self.mesh.local()
            per = batch // len(local.devices)
            progs = {}
            for dev in local.devices:
                if dev in progs:
                    continue
                det = self.det
                if dev != det.device:
                    det = self._replicas.get((dev, ver)) or self._replicas.setdefault((dev, ver), det.replica(dev))
                progs[dev] = det._batch_fn(per, self.padded_hw, self.size, identity=identity,
                                           max_dets=self.max_dets, int8_in=int8_in)
            wrapped = shard_batch_fn(None, local, num_batch_args=2, program_for=progs.__getitem__)
            self._dp_cache[key] = wrapped
        return wrapped

    def _launch(self, group: Sequence[_Request]) -> Tuple[Sequence[_Request], Any]:
        """Enqueue ONE program for the group; no host sync.

        Everything (assembly included) runs under the try: an exception must
        become set_exception on the group's futures, never a dead worker
        thread with callers blocked on unresolved futures."""
        try:
            return group, self._launch_inner(group)
        except Exception as e:
            for r in group:
                _resolve(r.future, exc=e)
            return group, None

    def _launch_inner(self, group: Sequence[_Request]):
        total = sum(r.n for r in group)
        # pad the coalesced batch up to the smallest ladder rung that fits,
        # so ragged tails and low-load singles ride a bounded program set;
        # a single request larger than device_batch runs at its own size,
        # rounded up to the mesh size under DP
        if total <= self.device_batch:
            b = min(r for r in self.batch_ladder if r >= total)
        else:
            b = -(-total // self._nd) * self._nd
        # pre-sized fast path: if every real image in the group is exactly
        # the model size, the whole launch can use the identity program, and
        # pad rows then carry hw=size so that one program fits
        identity = self.det._identity_for(self.padded_hw, self.size, np.concatenate([r.hws for r in group]))
        use_i8 = self.int8_input and identity
        fn, fmt = self._fn(b, identity=identity, int8_in=use_i8)
        if use_i8:
            # host-quantized staging: the stem's table applied while the
            # launch buffer is assembled, then the int8-input program. Pad
            # rows get LUT(0), the same black pixels the uint8 path's zero
            # fill means, so padded launches stay bit-identical.
            lut = self.det.stem_input_lut()
            imgs = np.empty((b, *self.padded_hw, 3), np.int8)
            hws = np.full((b, 2), self.size, np.int32)
            if b > total:
                imgs[total:] = lut[0]
            o = 0
            for r in group:
                native.stem_lut_apply(r.images, lut, out=imgs[o : o + r.n])
                hws[o : o + r.n] = r.hws
                o += r.n
        elif fmt is not None:
            # assembled straight into the signature's next pinned slot
            fill = self.size if identity else 1

            def assemble(imgs, hws):
                o = 0
                for r in group:
                    imgs[o : o + r.n] = r.images
                    hws[o : o + r.n] = r.hws
                    o += r.n
                imgs[o:] = 0
                hws[o:] = fill

            dev_im, dev_hw = fmt.stage(assemble)
        elif len(group) == 1 and group[0].n == b:
            # the request already spans the launch: no assembly copy
            imgs, hws = group[0].images, group[0].hws
        else:
            imgs = np.zeros((b, *self.padded_hw, 3), np.uint8)
            fill = self.size if identity else 1
            hws = np.full((b, 2), fill, np.int32)
            o = 0
            for r in group:
                imgs[o : o + r.n] = r.images
                hws[o : o + r.n] = r.hws
                o += r.n
        if fmt is None:
            if self.mesh is not None:
                local = self.mesh.local()
                dev_im, dev_hw = put_sharded(imgs, local), put_sharded(np.asarray(hws, np.int32), local)
            else:
                dev_im, dev_hw = stage_inputs(None, imgs, hws, self.det.device)
        res = fn(dev_im, dev_hw)
        # counted only once the launch succeeded: a build or staging error
        # above must not inflate launches/pad_images
        with self._stats_lock:
            self._n_launches += 1
            self._n_pad_images += b - total
            self._n_pinned += fmt is not None
        return res

    def _finalize(self, group: Sequence[_Request], res: Any) -> None:
        """Fetch a launched group's results and fulfil its futures. The copy
        to the host is where the worker waits for the device, and where a
        CUDA error of the launch surfaces: it fails this group alone."""
        if res is None:
            return
        try:
            host = tuple(t.cpu() for t in res)
            o = 0
            split: List[List[Detections]] = []
            for r in group:
                split.append(self.det.results_to_detections(host, self.thresh, lo=o, hi=o + r.n))
                o += r.n
        except Exception as e:
            for r in group:
                _resolve(r.future, exc=e)
            return
        now = time.perf_counter()
        with self._stats_lock:
            for r in group:
                self._lat_ms.append((now - r.t_submit) * 1e3)
                self._n_requests += 1
                self._n_images += r.n
        for r, out in zip(group, split):
            _resolve(r.future, result=out)

    def _coalesce(self, first: _Request) -> List[_Request]:
        group = [first]
        n = first.n
        while n < self.device_batch:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                break
            if r is None:  # shutdown sentinel: put it back for the loop
                self._queue.put(None)
                break
            if n + r.n > self.device_batch:
                # would overshoot device_batch: hold it for the next group
                # instead of building a program of a new batch size
                self._carry = r
                break
            group.append(r)
            n += r.n
        return group

    def _worker_loop(self) -> None:
        pending: collections.deque = collections.deque()
        while True:
            if self._carry is not None:
                r, self._carry = self._carry, None
            else:
                r = self._queue.get()
            if r is None:
                while pending:
                    self._finalize(*pending.popleft())
                return
            try:
                pending.append(self._launch(self._coalesce(r)))
                while len(pending) > self.inflight:
                    self._finalize(*pending.popleft())
                # idle: no queued or carried work -> drain the pipeline
                if self._carry is None and self._queue.empty():
                    while pending:
                        self._finalize(*pending.popleft())
            except Exception:  # pragma: no cover - _launch/_finalize convert
                # their own failures into future exceptions; this guard only
                # protects against the unexpected so the worker never dies
                # with callers blocked on unresolved futures
                continue

    # ------------------------------------------------------------------ #
    # async API
    # ------------------------------------------------------------------ #

    def _make_request(self, images: np.ndarray, hws: Optional[np.ndarray]) -> _Request:
        """Validate (fully, in the caller's thread: a malformed request must
        raise here, not kill the worker) and wrap one request."""
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"requests must be (B, H, W, 3), got {images.shape}")
        if images.dtype != np.uint8:
            raise ValueError(f"requests must be uint8, got {images.dtype}")
        if images.shape[1:3] != self.padded_hw:
            raise ValueError(
                f"request shape {images.shape[1:3]} != engine bucket {self.padded_hw}; pad first "
                "(preprocess.pad_to_bucket)"
            )
        if hws is None:
            hws = np.tile(np.array(self.padded_hw, np.int32)[None], (images.shape[0], 1))
        hws = np.asarray(hws, np.int32)
        if hws.shape != (images.shape[0], 2):
            raise ValueError(f"hws must be ({images.shape[0]}, 2), got {hws.shape}")
        return _Request(images, hws)

    def submit(self, images: np.ndarray, hws: Optional[np.ndarray] = None) -> Future:
        """Enqueue a (B, H, W, 3) uint8 request; Future -> List[Detections].

        Requests queued while a launch is in flight coalesce into the next
        launch (up to `device_batch` images a program)."""
        req = self._make_request(images, hws)
        # enqueue under the lock: close() also holds it, so a request can
        # never slip in after the shutdown sentinel drained (which would
        # leave its Future unresolved forever)
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingEngine is closed")
            if self._map_active:
                # the exclusivity is bidirectional: a map_stream() sweep
                # drives _launch/_finalize from its caller thread, and a
                # worker started now would interleave launches with it
                raise RuntimeError("submit() cannot run while a map_stream() sweep is active; use a separate engine")
            if self._worker is None:
                self._worker = threading.Thread(target=self._worker_loop, daemon=True)
                self._worker.start()
            self._queue.put(req)
        return req.future

    def stats(self) -> dict:
        """Serving counters and request-latency percentiles (ms) over the
        last 1024 completed requests (submit -> result: queueing, coalescing,
        device time and fetch). Thread-safe: snapshots the counters under
        the stats lock, so a monitoring thread can poll a live engine.
        `pinned_launches` counts the launches staged through pinned host
        buffers (`staging="formatted"` on a CUDA device)."""
        with self._stats_lock:
            lat = sorted(self._lat_ms)
            n_req, n_img = self._n_requests, self._n_images
            n_lau, n_pad, n_pin = self._n_launches, self._n_pad_images, self._n_pinned

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 2) if lat else None

        return {
            "requests": n_req,
            "images": n_img,
            "launches": n_lau,
            "mean_images_per_launch": round(n_img / n_lau, 1) if n_lau else None,
            # padded (wasted) device-batch rows; mean_fill = useful fraction
            "pad_images": n_pad,
            "mean_fill": round(n_img / (n_img + n_pad), 3) if n_img + n_pad else None,
            "pinned_launches": n_pin,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99),
            "latency_ms_max": round(lat[-1], 2) if lat else None,
        }

    def close(self) -> None:
        """Drain and stop the worker (idempotent).

        Holding the lock through the join is safe (the worker never takes
        it) and guarantees no submit() interleaves with the shutdown."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            if self._worker is not None:
                self._queue.put(None)
                self._worker.join()
                self._worker = None

    def __enter__(self) -> "ServingEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------------ #
    # synchronous stream API (offline sweeps)
    # ------------------------------------------------------------------ #

    def map_stream(
        self,
        batches: Iterable[Tuple[np.ndarray, Optional[np.ndarray]]],
    ) -> Iterator[List[Detections]]:
        """Coalesce an iterator of (images, hws) request batches; yield each
        request's List[Detections] in order.

        Greedily packs requests into `device_batch`-image launches with a
        depth-`inflight` pipeline of unfetched launches, so device compute
        overlaps the fetch of results.

        Mutually exclusive with the async submit() API on one engine: this
        drives _launch/_finalize from the caller thread, which must not
        interleave with the background worker's pipeline."""
        with self._lock:
            if self._worker is not None or self._map_active:
                raise RuntimeError(
                    "map_stream() cannot run while the submit() worker or another map_stream() sweep is active; "
                    "use a separate engine for the offline sweep"
                )
            self._map_active = True
        launched: collections.deque = collections.deque()
        done: List[_Request] = []
        group: List[_Request] = []
        n = 0

        def flush_group():
            nonlocal group, n
            if group:
                launched.append(self._launch(group))
                group, n = [], 0
                while len(launched) > self.inflight:
                    self._finalize(*launched.popleft())

        try:
            for images, hws in batches:
                r = self._make_request(images, hws)
                if n + r.n > self.device_batch:
                    flush_group()
                group.append(r)
                n += r.n
                done.append(r)
                while done and done[0].future.done():
                    yield done.pop(0).future.result()
            flush_group()
            while launched:
                self._finalize(*launched.popleft())
        finally:
            with self._lock:
                self._map_active = False
        for r in done:
            yield r.future.result()


class ServingRouter:
    """Multi-bucket front for ServingEngine: accepts images of any size.

    Each incoming image is zero-padded to its input-shape bucket on the host
    (preprocess.pad_to_bucket, which bounds the number of programs), then
    routed to a per-bucket ServingEngine, which coalesces same-bucket
    requests into large device batches. A mixed-shape stream therefore
    costs one program per active bucket instead of one per distinct shape.
    `mesh=` passes through to every engine."""

    def __init__(self, detector: Detector, device_batch: int = 128, **kw):
        _check_mesh(kw.get("mesh"))
        self.det = detector
        self.device_batch = device_batch
        self.kw = kw
        self._engines: dict = {}
        self._closed = False
        self._lock = threading.Lock()

    def _engine(self, padded_hw: Tuple[int, int]) -> ServingEngine:
        with self._lock:
            if self._closed:
                raise RuntimeError("ServingRouter is closed")
            eng = self._engines.get(padded_hw)
            if eng is None:
                eng = ServingEngine(self.det, padded_hw, device_batch=self.device_batch, **self.kw)
                self._engines[padded_hw] = eng
            return eng

    def submit(self, image: np.ndarray) -> Future:
        """One HxWx3 uint8 image of any size -> Future[Detections]."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"expected HxWx3 image, got {image.shape}")
        h, w = image.shape[:2]
        padded = pad_to_bucket(image)
        eng = self._engine(padded.shape[:2])
        inner = eng.submit(padded[None], np.array([[h, w]], np.int32))
        out: Future = Future()

        def unwrap(f: Future):
            try:
                out.set_result(f.result()[0])
            except Exception as e:  # propagated error path
                out.set_exception(e)

        inner.add_done_callback(unwrap)
        return out

    def stats(self) -> dict:
        """Per-bucket engine stats plus fleet totals (thread-safe)."""
        with self._lock:
            engines = dict(self._engines)
        per = {str(hw): eng.stats() for hw, eng in engines.items()}
        totals = {
            k: sum(s[k] for s in per.values())
            for k in ("requests", "images", "launches", "pad_images", "pinned_launches")
        }
        return {"buckets": per, **totals}

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            engines = list(self._engines.values())
            self._engines.clear()
        for eng in engines:
            eng.close()

    def __enter__(self) -> "ServingRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
