"""Detector API: `detect(image) -> Detections(boxes, scores, landmarks)`.

Mirrors `tpucenterface/detector.py::Detections` and `Detector` (`__init__`,
`from_safetensors`, `from_torch_pth`, `_decode`, `_forward`,
`results_to_detections`, `_identity_for`, `_get_or_build`, `_single_fn`, `_batch_fn`,
`_batch_fn_auto`, `_batch_flip_fn`, `reload_weights`, `weights_version`,
`detect`, `detect_batch`, `warmup`, `quantize`, `quant_variables`,
`last_qat_metrics`, `last_adaround_report`, `dequantize`, `stem_input_lut`),
`stage_inputs` and `_export_scales`; `quantize_unsupported` says why `quantize()`
would refuse a model, for callers that check before they ask:

    host:   zero-pad the frame to a shape bucket, copy to the device
    device: letterbox+normalize -> backbone -> neck -> heads -> decode
            -> inverse letterbox
    host:   threshold filter of the fixed-K result

Construction folds BatchNorm, fuses the heads and bakes the input normalize
into the stem as the JAX Detector does. Everything runs eagerly: where the
JAX Detector jits a program per signature (`_single_fn`, `_batch_fn`,
`_batch_flip_fn`), the port returns a closure over the same eager torch ops,
which takes device tensors of that signature. The device is the GPU unless
the caller passes another; asking for the GPU on a machine without one
raises.

Two switches of the config choose kernels of the port:
- `ModelConfig.inference_engine`: the default `"flax"` is the module forward;
  `"fast"` runs the forward through `model.fast_forward.FastEngine` with the
  fused MBConv kernel (`ops.fused_mbconv`); `"planar"` runs it through
  `model.planar_engine.PlanarEngine` with every run of stride-1 blocks on a
  map at most `PLANAR_CHAIN_RES` rows high as one launch of the planar chain
  kernel (`ops.planar_mbconv.planar_mbconv_chain`).
- `DecodeConfig.use_pallas` takes the fused decode kernel
  (`decode.fused_decode`) for a model without a landmark head, and the fused
  sigmoid + pseudo-NMS kernel (`decode.fused_nms`) ahead of the reference
  top-K and gathers for a model with one.

`quantize()` switches the forward to the W8A8 engine (`quant.QuantEngine`),
calibrated on uint8 frames or installed from persisted scales;
`quantize(fused_blocks=True)` (with `int8_dw=True`) runs its stride-1
residual blocks through the int8 block kernel (`ops.int8_block`).
`quantize(adaround_steps=, qat_steps=)` fine-tunes the engine's weights on
the calibration frames (`quant.adaround`, then `quant.qat`; reports in
`last_adaround_report` and `last_qat_metrics`), and `quantize(scales=,
quant_params=)` installs a persisted pair (`quant_variables`, or
`weights.io.load_packed_weights`). `dequantize()` returns to the bf16
forward.

Swaps are atomic, as in the JAX Detector: `reload_weights`, `quantize` and
`dequantize` build their new state first, then assign every field, bump
`weights_version` and clear the program cache under `_fn_lock`. A program
is built from one snapshot of the weights and forward (`_Generation`) and
runs wholly on it, whatever swap follows; the cache keys on
`weights_version` (`_get_or_build`).

Input staging (`_batch_fn_auto`, `stage_inputs`): where the JAX Detector
stages a launch into XLA's preferred input layouts, the port stages it
through a ring of reused pinned host buffers and a copy stream
(`PinnedStaging`), so that the copy of launch N+1 runs beside program N.

Spans (`runtime.profiling.annotate`, a check and nothing more without a
profiler): `stage_inputs` runs inside `tcf.stage`; a batch program's
layers inside `tcf.preprocess`, `tcf.forward` and `tcf.decode`;
`results_to_detections` inside `tcf.results`; a program built on a cache
miss inside `tcf.build`.

The space-to-depth stem (`ModelConfig.s2d_stem`) follows the JAX
Detector's rules: a 3x3 stem is remapped after the stem bake when every
bucket and `default_size` are even; a model built with the 2x2 stem is an s2d
model and skips the bake; either way the folded config says `s2d_stem=True`.
An engine runs only where it can (`_build_engine`); an s2d model, unfolded
weights or, for the fast engine, a compute dtype other than bfloat16 take the
module forward.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpucenterface_torch.config import DetectorConfig, resolve_device
from tpucenterface_torch.decode.fused_decode import decode_feats_fused
from tpucenterface_torch.decode.fused_nms import sigmoid_pseudo_nms_fused
from tpucenterface_torch.decode.reference import (
    boxes_to_original,
    decode_feats_with_idx,
    decode_landmarks,
    landmarks_to_original,
)
from tpucenterface_torch.model.centernet import init_model, load_network
from tpucenterface_torch.model.fast_forward import FastEngine
from tpucenterface_torch.model.planar_engine import PlanarEngine
from tpucenterface_torch.preprocess import (
    letterbox_normalize_batch,
    normalize_images,
    pad_to_bucket,
)
from tpucenterface_torch.quant.adaround import adaround
from tpucenterface_torch.quant.engine import QuantEngine, stem_input_lut
from tpucenterface_torch.quant.qat import qat_finetune
from tpucenterface_torch.runtime.profiling import annotate
from tpucenterface_torch.weights.fold import fold_variables
from tpucenterface_torch.weights.io import load_safetensors
from tpucenterface_torch.weights.port import load_torch_pth


# The planar engine chains stride-1 blocks on maps up to this many rows high:
# at a 640 input blocks 4-5 (80x80), 7-12 (40x40) and 14-16 (20x20), three
# launches a forward; at 320 block 2 (80x80) as well, four. The JAX Detector
# builds its planar engine with no chain at all (`max_chain_res=0`); the port
# turns the kernel on, as it does for the fast engine, so that choosing the
# engine chooses the kernel.
PLANAR_CHAIN_RES = 80


def _export_scales(eng: QuantEngine) -> Dict[str, Any]:
    """The installable, persistable scales dict of a quantized engine: its
    activation scales, its fixed "w:<tag>" weight scales, and the
    "cfg:weight_bits" and "cfg:int8_dw" entries that make it self-describing."""
    out = dict(eng.act_scales)
    out.update({f"w:{t}": np.asarray(s) for t, s in eng.weight_scales.items()})
    out["cfg:weight_bits"] = eng.weight_bits
    out["cfg:int8_dw"] = int(eng.int8_dw)
    return out


# Pinned host slots of a staging ring: a serving engine keeps `inflight`
# launches unfetched (2 by default), and a slot may be written again only
# once the copy that read it has completed, so inflight + 1 slots let the
# assembly of the next launch go on without waiting.
STAGING_SLOTS = 3


class PinnedStaging:
    """The staging format of one launch signature (batch, padded_hw) on a
    CUDA device: a ring of reused pinned host buffers (uint8 images, int32
    hws), a copy stream, and per slot the event recorded after its last
    host-to-device copy.

    `stage(fill)` takes the next slot, waits until the copy that last read
    it has completed, lets `fill(imgs, hws)` write the launch into the
    slot's numpy views, copies both buffers to the device with
    `non_blocking=True` on the copy stream, and makes the caller's stream
    wait for the copy. The device tensors are allocated on the copy stream
    and `record_stream`'d to the caller's, so the caching allocator hands
    their memory out again only after the caller's work queued until they
    are freed. The caller's stream thus runs the program as soon as its
    inputs have arrived, while the copy of the next launch runs beside it.
    A pinned allocation that fails raises. Thread-safe: one slot is taken,
    filled and issued at a time."""

    def __init__(self, batch: int, padded_hw: Tuple[int, int], device, slots: int = STAGING_SLOTS):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"pinned staging is for a CUDA device, not {self.device}")
        if slots < 2:
            raise ValueError(f"a staging ring needs at least 2 slots, got {slots}")
        self.shape = (batch, *padded_hw, 3)
        self.stream = torch.cuda.Stream(device=self.device)
        self._imgs = [torch.empty(self.shape, dtype=torch.uint8, pin_memory=True) for _ in range(slots)]
        self._hws = [torch.empty((batch, 2), dtype=torch.int32, pin_memory=True) for _ in range(slots)]
        self._views = [(i.numpy(), h.numpy()) for i, h in zip(self._imgs, self._hws)]
        self._copied: List[Optional[torch.cuda.Event]] = [None] * slots
        self._next = 0
        self._lock = threading.Lock()

    def stage(self, fill) -> Tuple[torch.Tensor, torch.Tensor]:
        with self._lock:
            k = self._next
            self._next = (k + 1) % len(self._imgs)
            if self._copied[k] is not None:
                self._copied[k].synchronize()  # the slot's last copy has read it
            fill(*self._views[k])
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.stream):
                dev_im = torch.empty(self.shape, dtype=torch.uint8, device=self.device)
                dev_hw = torch.empty(self._hws[k].shape, dtype=torch.int32, device=self.device)
                dev_im.copy_(self._imgs[k], non_blocking=True)
                dev_hw.copy_(self._hws[k], non_blocking=True)
                done = torch.cuda.Event()
                done.record(self.stream)
            compute.wait_event(done)
            dev_im.record_stream(compute)
            dev_hw.record_stream(compute)
            self._copied[k] = done
        return dev_im, dev_hw


def stage_inputs(fmt: Optional[PinnedStaging], imgs: np.ndarray, hws: np.ndarray, device=None):
    """Stage a (images, hws) launch for a `_batch_fn_auto` program: through
    the program's pinned staging ring when `fmt` is one, else the pageable
    `.to(device)` copy (on a CUDA device it waits for the work queued ahead
    on the stream). Where a batch launch's inputs reach the device, for
    `detect_batch`, `ServingEngine` and the batched runners of
    `eval.batch_runner` alike (`detect` copies its one frame itself), inside
    the span `tcf.stage`."""
    with annotate("tcf.stage"):
        if fmt is None:
            dev = resolve_device(device)
            return (torch.from_numpy(np.ascontiguousarray(imgs)).to(dev),
                    torch.from_numpy(np.ascontiguousarray(hws, np.int32)).to(dev))
        imgs = np.asarray(imgs)
        hws = np.asarray(hws, np.int32)
        if imgs.shape != fmt.shape or imgs.dtype != np.uint8 or hws.shape != (fmt.shape[0], 2):
            raise ValueError(f"staging takes uint8 {fmt.shape} and hws ({fmt.shape[0]}, 2), got "
                             f"{imgs.dtype} {imgs.shape} and {hws.shape}")

        def fill(im, hw):
            np.copyto(im, imgs)
            np.copyto(hw, hws)

        return fmt.stage(fill)


def quantize_unsupported(model) -> Optional[str]:
    """Why `Detector.quantize()` refuses a Detector of this (folded) model
    config, or None where it takes it."""
    if not model.folded:
        return "quantize() requires folded inference weights"
    if model.s2d_stem:
        return "quantize() does not support s2d stems (the int8 engine runs the standard 3x3/s2 stem)"
    if model.head_conv <= 0:
        return ("quantize() requires head_conv > 0 (the int8 engine runs the fused-head form, which needs the "
                "hidden head conv)")
    return None


def _decode_with(cfg, feats: Dict[str, torch.Tensor], max_dets: Optional[int] = None):
    """`Detector._decode` under the decode config `cfg`."""
    if max_dets is not None and max_dets != cfg.max_dets:
        cfg = dataclasses.replace(cfg, max_dets=max_dets)
    if cfg.use_pallas and "lm" not in feats:
        boxes, scores, _ = decode_feats_fused(feats, cfg)
        return boxes, scores, None
    peaks = sigmoid_pseudo_nms_fused(feats["hm"][..., 0]) if cfg.use_pallas else None
    boxes, scores, idx = decode_feats_with_idx(feats, cfg, peaks=peaks)
    lm = decode_landmarks(feats, idx, cfg) if "lm" in feats else None
    return boxes, scores, lm


def _build_engine(variables: Dict[str, Any], model_cfg, device):
    """The forward engine `model_cfg.inference_engine` names, or None for
    the module forward. As in the JAX Detector, an engine is built only
    where it runs the model: folded weights and the 3x3 stem (an s2d model
    keeps the module forward); otherwise the module forward runs. The fast
    engine's kernel computes in bfloat16 only, so another compute dtype
    takes the module forward, as the JAX Detector does for every name but
    "planar"; the planar engine chains stride-1 blocks through its kernel in
    bfloat16 and, in another dtype, runs with no chain (`max_chain_res=0`,
    the JAX Detector's own setting). A name no engine has raises."""
    name = model_cfg.inference_engine
    if name not in ("flax", "fast", "planar"):
        raise NotImplementedError(f"the port has no '{name}' inference engine")
    if not model_cfg.folded or model_cfg.s2d_stem:
        return None
    bf16 = model_cfg.compute_dtype == "bfloat16"
    if name == "fast" and bf16:
        return FastEngine(variables, model_cfg, use_mbconv_kernel=True, device=device)
    if name == "planar":
        return PlanarEngine(variables, model_cfg, max_chain_res=PLANAR_CHAIN_RES if bf16 else 0, device=device)
    return None


class _Generation(NamedTuple):
    """One generation of a Detector's weights and forward, as one swap left
    them: what a program built at `version` runs, whatever swap follows."""

    version: int
    config: DetectorConfig
    model: Any
    engine: Any
    quant: Optional[QuantEngine]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.quant is not None:
            return self.quant(x)
        if self.engine is not None:
            return self.engine(x)
        return self.model(x)


class Detections(NamedTuple):
    """Typed detect() result; `landmarks` is None without the landmark head."""

    boxes: np.ndarray              # (N, 4) [x1,y1,x2,y2] original-image px
    scores: np.ndarray             # (N,) float32, descending
    landmarks: Optional[np.ndarray] = None  # (N, 5, 2) or None


class Detector:
    """Face detector: model weights + the preprocess -> forward -> decode path."""

    def __init__(
        self,
        variables: Optional[Dict[str, Any]] = None,
        config: DetectorConfig = DetectorConfig(),
        device=None,
        fold_bn: bool = True,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self._init_config, self._init_fold_bn = config, fold_bn
        self.config = config
        if variables is None:
            _, variables = init_model(config.model, seed=seed)
        if fold_bn and not config.model.folded and "batch_stats" in variables:
            fuse = config.model.head_conv > 0
            # the space-to-depth stem needs every input even: remap only then
            s2d = (
                config.model.s2d_stem
                and all(b % 2 == 0 for b in config.buckets)
                and config.default_size % 2 == 0
            )
            # a model built with s2d_stem=True carries the 2x2 stem already;
            # only a 3x3 stem is remapped, and only a 3x3 stem takes the bake
            stem_kh = int(np.shape(variables["params"]["backbone"]["stem"]["conv"]["kernel"])[0])
            bake = config.preprocess.stem_bake and stem_kh == 3
            variables = fold_variables(
                variables,
                bn_eps=config.model.bn_eps,
                fuse_heads=fuse,
                s2d_stem=s2d and stem_kh == 3,
                bake_preprocess=config.preprocess if bake else None,
            )
            self.config = dataclasses.replace(
                config,
                model=dataclasses.replace(
                    config.model, folded=True, fused_heads=fuse, s2d_stem=s2d or stem_kh == 2, stem_preprocess=bake
                ),
            )
        self.variables = variables
        # An engine holds its own copies of the block weights beside the
        # network it builds; `model` is that network, so there is one of it.
        self._engine = _build_engine(variables, self.config.model, self.device)
        self.model = self._engine.net if self._engine is not None else load_network(
            variables, self.config.model, self.device)
        self._quant: Optional[QuantEngine] = None  # set by quantize()
        self.last_qat_metrics = None  # quantize(qat_steps=) metrics
        self.last_adaround_report = None  # quantize(adaround_steps=) report
        self._stem_lut: Optional[np.ndarray] = None
        # bumped on every weight or forward swap (reload_weights, quantize,
        # dequantize); the program cache and callers that cache anything
        # derived from the weights key on it
        self.weights_version = 0
        # every swap assigns its fields, bumps the version and clears the
        # program cache under this lock; programs are built from a snapshot
        # taken under it (`_get_or_build`)
        self._fn_lock = threading.Lock()
        self._fn_cache: Dict[Tuple, Any] = {}
        # pinned staging rings by (batch, padded_hw, slots): they hold no
        # weights, so they outlive swaps
        self._staging: Dict[Tuple, PinnedStaging] = {}

    @classmethod
    def from_safetensors(
        cls, path: str, config: DetectorConfig = DetectorConfig(), device=None
    ) -> "Detector":
        return cls(variables=load_safetensors(path, config.model), config=config, device=device)

    @classmethod
    def from_torch_pth(
        cls, path: str, config: DetectorConfig = DetectorConfig(), device=None
    ) -> "Detector":
        """Port a torch `.pth` state_dict checkpoint named after the twin
        contract (`weights.port.load_torch_pth`)."""
        return cls(variables=load_torch_pth(path, config.model), config=config, device=device)

    def reload_weights(
        self,
        variables: Optional[Dict[str, Any]] = None,
        safetensors_path: Optional[str] = None,
        torch_pth_path: Optional[str] = None,
    ) -> None:
        """Swap the model weights (a rolling update under live serving).
        The new weights go through the same construction as `__init__`
        (BatchNorm fold, head fusion, engine build), so an engine's own block
        weights are rebuilt with the network; then every field is assigned,
        the version bumped and the program cache cleared under `_fn_lock`.
        Programs built before the swap keep running on the old weights; every
        program built after it runs on the new. An active int8 forward is
        dropped: quantize() again for the new weights."""
        if safetensors_path is not None:
            variables = load_safetensors(safetensors_path, self._init_config.model)
        elif torch_pth_path is not None:
            variables = load_torch_pth(torch_pth_path, self._init_config.model)
        elif variables is None:
            raise ValueError("pass variables, safetensors_path, or torch_pth_path")
        fresh = Detector(
            variables=variables,
            config=self._init_config,
            device=self.device,
            fold_bn=self._init_fold_bn,
        )
        with self._fn_lock:
            self.variables, self.config = fresh.variables, fresh.config
            self.model, self._engine = fresh.model, fresh._engine
            self._quant = None
            self.weights_version += 1
            self._fn_cache.clear()

    def replica(self, device) -> "Detector":
        """A Detector on `device` running this one's current weights and
        forward (the engine, and the int8 forward with its scales and
        params), read together under `_fn_lock`: a data-parallel launch's
        program on another device. It does not follow later swaps; callers
        key it on the `weights_version` it was made at."""
        with self._fn_lock:
            variables, config, quant = self.variables, self.config, self._quant
        rep = Detector(variables=variables, config=config, device=device, fold_bn=False)
        if quant is not None:
            rep.quantize(scales=_export_scales(quant), quant_params=quant.p, fused_blocks=quant.fused_blocks)
        return rep

    # ------------------------------------------------------------------ #
    # the int8 forward
    # ------------------------------------------------------------------ #

    def quantize(
        self,
        calib_images: Optional[np.ndarray] = None,
        calib_batches: Optional[list] = None,
        size: Optional[int] = None,
        int8_dw: bool = False,
        scales: Optional[Dict[str, Any]] = None,
        calib_percentile: Optional[float] = None,
        qat_steps: int = 0,
        qat_lr: float = 1e-4,
        adaround_steps: int = 0,
        quant_params: Optional[Dict[str, Any]] = None,
        weight_bits: int = 8,
        fused_blocks: bool = False,
    ) -> Dict[str, Any]:
        """Switch this Detector to the W8A8 int8 forward (opt-in
        post-training quantization) and return its persistable scales.

        Calibration: raw uint8 images (N, H, W, 3), letterboxed and
        normalized at `size` as detect does, or normalized NHWC batches; or
        install persisted `scales` (self-describing: their "cfg:weight_bits"
        and "cfg:int8_dw" entries win over the arguments). int8_dw: the
        depthwise convs in int8 too, with per-channel scales. weight_bits: 8
        down to 2. calib_percentile: clip-calibrate at that percentile of
        |x|. fused_blocks (needs int8_dw): the stride-1 residual blocks run
        through the int8 block kernel.

        Fine-tuning on the calibration batches, in the JAX order:
        adaround_steps > 0 learns each weight's rounding (`quant.adaround`;
        the learned rounding rides the returned scales' "w:<tag>" entries and
        the engine's on-grid params, report in `last_adaround_report`), then
        qat_steps > 0 bias-corrects and STE-fine-tunes at qat_lr
        (`quant.qat`, distilling toward the params from before AdaRound;
        metrics in `last_qat_metrics`). Both run on the engine's per-conv
        route; under fused_blocks the block kernel then serves the tuned
        weights. Persist the scales and `quant_variables`, and install both
        with quantize(scales=..., quant_params=...). The bf16 weights stay;
        dequantize() returns to them."""
        model = self.config.model
        reason = quantize_unsupported(model)
        if reason is not None:
            raise ValueError(reason)
        if scales is not None and "cfg:weight_bits" in scales:
            weight_bits = int(scales["cfg:weight_bits"])
        if scales is not None and "cfg:int8_dw" in scales:
            int8_dw = bool(int(scales["cfg:int8_dw"]))
        eng = QuantEngine(
            self.variables, model, int8_dw=int8_dw, pp_cfg=self.config.preprocess, weight_bits=weight_bits,
            fused_blocks=fused_blocks, device=self.device,
        )
        if quant_params is not None:
            if scales is None:
                raise ValueError(
                    "quant_params requires scales= (pass the persisted pair exported by quantize(); recalibrating "
                    "on top of fine-tuned params would corrupt both the weight scales and the distillation "
                    "teacher)"
                )
            if "params" in quant_params and "backbone" not in quant_params:
                quant_params = quant_params["params"]
            eng.p = quant_params
        if scales is not None:
            if qat_steps or adaround_steps:
                raise ValueError(
                    "qat_steps/adaround_steps need calibration batches (pass calib_images/calib_batches); with "
                    "persisted scales, install the persisted fine-tuned params via quant_params= instead"
                )
            eng.set_scales(scales)
        else:
            if calib_batches is not None:
                xs = [torch.as_tensor(b).to(self.device) for b in calib_batches]
            elif calib_images is not None:
                size = size or self.config.default_size
                imgs = torch.from_numpy(np.ascontiguousarray(calib_images, np.uint8)).to(self.device)
                hws = torch.tensor(imgs.shape[1:3], dtype=torch.int32, device=self.device).repeat(imgs.shape[0], 1)
                with torch.inference_mode():
                    x, _, _ = letterbox_normalize_batch(imgs, hws, size, self.config.preprocess, raw=model.stem_preprocess)
                xs = [x]
            else:
                raise ValueError("pass calib_images (uint8), calib_batches, or scales")
            eng.calibrate(xs, percentile=calib_percentile)
            float_params = eng.p  # the float model before fine-tuning: QAT's teacher
            if adaround_steps:
                self.last_adaround_report = adaround(eng, xs, steps=adaround_steps)
            if qat_steps:
                self.last_qat_metrics = qat_finetune(eng, xs, steps=qat_steps, lr=qat_lr, teacher_params=float_params)
        with self._fn_lock:
            self._quant = eng
            self.weights_version += 1
            self._fn_cache.clear()  # programs rebuild on the int8 forward
        return _export_scales(eng)

    @property
    def quant_variables(self) -> Dict[str, Any]:
        """{"params": ...} of the active int8 forward: the engine's params,
        which differ from the Detector's after fine-tuning. Persist with
        `weights.io.save_safetensors` and reinstall with
        quantize(scales=..., quant_params=...)."""
        if self._quant is None:
            raise ValueError("quant_variables requires a quantize()d detector")
        return {"params": self._quant.p}

    def dequantize(self) -> None:
        """Return to the bf16 forward."""
        with self._fn_lock:
            if self._quant is not None:
                self._quant = None
                self.weights_version += 1
                self._fn_cache.clear()

    def stem_input_lut(self) -> np.ndarray:
        """(256, 3) int8 table of the stem's int8 input for each uint8 pixel
        value (`quant.engine.stem_input_lut`), built once on this Detector's
        device; it depends on the preprocess config alone."""
        if self._quant is None or not self.config.model.stem_preprocess:
            raise ValueError("stem_input_lut requires a quantize()d detector with the stem-baked preprocess")
        if self._stem_lut is None:
            self._stem_lut = stem_input_lut(self.config.preprocess, self.device)
        return self._stem_lut

    # ------------------------------------------------------------------ #
    # the device path
    # ------------------------------------------------------------------ #

    def _decode(self, feats: Dict[str, torch.Tensor], max_dets: Optional[int] = None):
        """-> (boxes, scores, landmarks-or-None), all in model-input pixels;
        K = min(max_dets, H*W) on every route, `max_dets` overriding
        DecodeConfig.max_dets for this call. With `use_pallas`, a model
        without a landmark head takes the fused decode kernel, and one with a
        landmark head takes the fused sigmoid + pseudo-NMS kernel for the
        dense stage ahead of the reference top-K and gathers (bit-equal to
        the reference decode)."""
        return _decode_with(self.config.decode, feats, max_dets)

    def _generation(self) -> _Generation:
        """The current weights and forward, read together under `_fn_lock`."""
        with self._fn_lock:
            return _Generation(self.weights_version, self.config, self.model, self._engine, self._quant)

    def _forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The current forward (int8 engine, fast or planar engine, or the
        module network) on a normalized NHWC batch."""
        return self._generation().forward(x)

    def _get_or_build(self, key: Tuple, builder):
        """Program-cache access: read under the lock, build outside it, insert
        with setdefault under it, so that concurrent builders converge on one
        program. The key carries the `weights_version` of the snapshot that
        `builder(generation)` builds from, and a program built from a
        generation that a swap has already replaced is returned to its caller
        but not cached, so no entry of an old generation stays reachable."""
        gen = self._generation()
        key = key + (gen.version,)
        with self._fn_lock:
            fn = self._fn_cache.get(key)
        if fn is not None:
            return fn
        with annotate("tcf.build"):
            run = builder(gen)
        with self._fn_lock:
            if self.weights_version != gen.version:
                return run
            return self._fn_cache.setdefault(key, run)

    def _identity_for(self, padded_hw, size: int, hws) -> bool:
        """True when every image in the call is exactly the model size, so
        the letterbox is the identity (PreprocessConfig.identity_fast_path)."""
        return (
            self.config.preprocess.identity_fast_path
            and tuple(padded_hw) == (size, size)
            and bool((np.asarray(hws) == size).all())
        )

    def results_to_detections(
        self, res, thresh: float, lo: int = 0, hi: Optional[int] = None
    ) -> List[Detections]:
        """Split a (boxes, scores[, landmarks]) tensor result into per-image
        thresholded `Detections` for images lo..hi-1 (all by default), inside
        the span `tcf.results` (the fetch waits for the launch)."""
        with annotate("tcf.results"):
            boxes, scores = res[0].cpu().numpy(), res[1].cpu().numpy()
            lms = res[2].cpu().numpy() if len(res) == 3 else None
            hi = boxes.shape[0] if hi is None else hi
            out: List[Detections] = []
            for i in range(lo, hi):
                keep = scores[i] >= thresh
                out.append(
                    Detections(boxes[i][keep], scores[i][keep], lms[i][keep] if lms is not None else None)
                )
            return out

    # ------------------------------------------------------------------ #
    # programs: one per signature and weights generation, as the JAX
    # Detector's jitted ones
    # ------------------------------------------------------------------ #

    def _build_batch(self, gen: _Generation, batch: int, size: int, identity: bool,
                     max_dets: Optional[int], int8_in: bool):
        """The batch program of `gen` (see `_batch_fn`): a closure over that
        generation's config and forward, never over `self`'s fields."""
        cfg = gen.config
        if int8_in:
            if not identity:
                raise ValueError("int8_in requires the identity path")
            if gen.quant is None or not cfg.model.stem_preprocess:
                raise ValueError(
                    "int8_in requires a quantize()d detector with the stem-baked preprocess (stem_preprocess=True)"
                )
        raw = cfg.model.stem_preprocess
        pp = cfg.preprocess
        dev = self.device

        def run(imgs_u8: torch.Tensor, hws: torch.Tensor):
            # the rows come from the inputs, not from `batch`: a data-parallel
            # launch runs the program on each device's share of the batch
            n = imgs_u8.shape[0]
            with torch.inference_mode():
                with annotate("tcf.preprocess"):
                    if int8_in or identity:
                        # int8_in: already quantized through the stem's table
                        # on the host; the engine's stem takes int8 as it is
                        # (QuantEngine._conv)
                        x = imgs_u8 if int8_in else normalize_images(imgs_u8, pp, raw=raw)
                        scales = torch.ones((n,), dtype=torch.float32, device=dev)
                        pads = torch.zeros((n, 2), dtype=torch.float32, device=dev)
                    else:
                        x, scales, pads = letterbox_normalize_batch(imgs_u8, hws, size, pp, raw=raw)
                with annotate("tcf.forward"):
                    feats = gen.forward(x)
                with annotate("tcf.decode"):
                    boxes, scores, lm = _decode_with(cfg.decode, feats, max_dets)
                    boxes = boxes_to_original(boxes, scales, pads, hws)
                    if lm is None:
                        return boxes, scores
                    return boxes, scores, landmarks_to_original(lm, scales, pads, hws)

        return run

    def _single_fn(self, padded_hw: Tuple[int, int], size: int, identity: bool = False):
        """The one-image program: (uint8 (Hp, Wp, 3), hw (2,) int32) device
        tensors -> boxes (K, 4), scores (K,)[, landmarks (K, 5, 2)] in
        original-image pixels: the batch program of one image."""

        def build(gen):
            batch = self._build_batch(gen, 1, size, identity, None, False)

            def run(img_u8: torch.Tensor, hw: torch.Tensor):
                return tuple(r[0] for r in batch(img_u8[None], hw[None]))

            return run

        return self._get_or_build(("single", tuple(padded_hw), size, identity), build)

    def _batch_fn(
        self,
        batch: int,
        padded_hw: Tuple[int, int],
        size: int,
        identity: bool = False,
        max_dets: Optional[int] = None,
        int8_in: bool = False,
    ):
        """The batch program: ((B, Hp, Wp, 3) uint8, (B, 2) int32) device
        tensors -> boxes (B, K, 4), scores (B, K)[, landmarks (B, K, 5, 2)]
        in original-image pixels, K = min(max_dets or DecodeConfig.max_dets,
        H*W) of the head maps.

        int8_in: the program takes host-quantized int8 images (the stem's
        table applied while the launch is staged, `stem_input_lut`) instead
        of raw uint8, and skips the input quantize of the int8 forward's
        stem. It needs the int8 forward (quantize()), a stem-baked model and
        the identity (pre-sized) path: the letterbox resize is a float op and
        cannot take quantized pixels. Raises ValueError otherwise."""
        key = ("batch", batch, tuple(padded_hw), size, identity, max_dets, int8_in)
        return self._get_or_build(
            key, lambda gen: self._build_batch(gen, batch, size, identity, max_dets, int8_in)
        )

    def _batch_fn_auto(
        self,
        batch: int,
        padded_hw: Tuple[int, int],
        size: int,
        identity: bool = False,
        max_dets: Optional[int] = None,
        int8_in: bool = False,
        slots: int = STAGING_SLOTS,
    ):
        """`_batch_fn` and the staging format its inputs take: (program, fmt)
        for `stage_inputs`. On a CUDA device fmt is the `PinnedStaging` ring
        of `slots` pinned slots of this launch signature (shared by every
        caller of the signature, kept across weight swaps); on the CPU, where
        there is no transfer to stage, and for the int8-input program, as the
        JAX Detector does, fmt is None: the pageable copy."""
        fn = self._batch_fn(batch, padded_hw, size, identity=identity, max_dets=max_dets, int8_in=int8_in)
        return fn, None if int8_in else self._staging_for(batch, padded_hw, slots)

    def _staging_for(self, batch: int, padded_hw: Tuple[int, int], slots: int = STAGING_SLOTS):
        """The `PinnedStaging` ring of a (batch, padded_hw) launch on this
        Detector's CUDA device, made at first use; None on the CPU."""
        if self.device.type != "cuda":
            return None
        key = (batch, tuple(padded_hw), slots)
        with self._fn_lock:
            fmt = self._staging.get(key)
        if fmt is None:
            fmt = PinnedStaging(batch, padded_hw, self.device, slots)
            with self._fn_lock:
                fmt = self._staging.setdefault(key, fmt)
        return fmt

    def _batch_flip_fn(self, batch: int, padded_hw: Tuple[int, int], size: int):
        """The batch program of the image and its horizontal mirror in one
        forward of 2B images: the letterboxed square is mirrored on the
        device, and the mirror's boxes (pixel x -> (size - 1) - x) and
        landmarks (x un-mirrored, left/right pairs swapped by
        DecodeConfig.lm_flip_perm) are un-mirrored before the inverse
        letterbox. Needs a centered letterbox. Returns boxes (B, 2K, 4),
        scores (B, 2K)[, landmarks (B, 2K, 5, 2)]: the first K of each row
        from the image, the second K from its mirror; the caller merges."""

        def build(gen):
            cfg = gen.config
            if not cfg.preprocess.center:
                raise ValueError("the flip program needs a centered letterbox (PreprocessConfig.center)")
            raw = cfg.model.stem_preprocess
            pp = cfg.preprocess
            perm = list(cfg.decode.lm_flip_perm)
            edge = size - 1.0

            def run(imgs_u8: torch.Tensor, hws: torch.Tensor):
                with torch.inference_mode():
                    with annotate("tcf.preprocess"):
                        x, scales, pads = letterbox_normalize_batch(imgs_u8, hws, size, pp, raw=raw)
                        x = torch.cat([x, x.flip(2)])
                    with annotate("tcf.forward"):
                        feats = gen.forward(x)
                    with annotate("tcf.decode"):
                        boxes, scores, lm = _decode_with(cfg.decode, feats)
                        mir = boxes[batch:]
                        mir = torch.stack([edge - mir[..., 2], mir[..., 1], edge - mir[..., 0], mir[..., 3]],
                                          dim=-1)
                        boxes = boxes_to_original(torch.cat([boxes[:batch], mir], dim=1), scales, pads, hws)
                        scores = torch.cat([scores[:batch], scores[batch:]], dim=1)
                        if lm is None:
                            return boxes, scores
                        lm_mir = lm[batch:]
                        lm_mir = torch.stack([edge - lm_mir[..., 0], lm_mir[..., 1]], dim=-1)[:, :, perm, :]
                        lm = landmarks_to_original(torch.cat([lm[:batch], lm_mir], dim=1), scales, pads, hws)
                        return boxes, scores, lm

            return run

        return self._get_or_build(("batch_flip", batch, tuple(padded_hw), size), build)

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #

    def detect(
        self,
        image: np.ndarray,
        score_thresh: Optional[float] = None,
        size: Optional[int] = None,
    ) -> Detections:
        """Detect faces in one HxWx3 uint8 (BGR by default) image; boxes in
        original pixel coordinates, scores descending, filtered at
        `score_thresh`. Another dtype goes to the program as it is, as in the
        JAX Detector: the letterbox casts the pixels to its resize dtype."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"detect() expects an HxWx3 color image, got shape {image.shape}")
        thresh = self.config.decode.score_thresh if score_thresh is None else score_thresh
        size = size or self.config.default_size
        h, w = image.shape[:2]
        padded = pad_to_bucket(image)
        identity = self._identity_for(padded.shape[:2], size, (h, w))
        fn = self._single_fn(padded.shape[:2], size, identity=identity)
        out = fn(
            torch.from_numpy(np.ascontiguousarray(padded)).to(self.device),
            torch.tensor([h, w], dtype=torch.int32, device=self.device),
        )
        boxes, scores = out[0].cpu().numpy(), out[1].cpu().numpy()
        keep = scores >= thresh
        lm = out[2].cpu().numpy()[keep] if len(out) == 3 else None
        return Detections(boxes[keep], scores[keep], lm)

    def detect_batch(
        self,
        images: np.ndarray,
        hws: Optional[np.ndarray] = None,
        score_thresh: Optional[float] = None,
        size: Optional[int] = None,
    ) -> List[Detections]:
        """Batched detect over images of one padded shape (B, Hp, Wp, 3)
        uint8 (another dtype goes to the program as it is, as in `detect`);
        `hws` (B, 2) gives each image's content size (default: the whole
        padded shape)."""
        thresh = self.config.decode.score_thresh if score_thresh is None else score_thresh
        size = size or self.config.default_size
        b = images.shape[0]
        if hws is None:
            hws = np.tile(np.array(images.shape[1:3], np.int32), (b, 1))
        identity = self._identity_for(images.shape[1:3], size, hws)
        fn = self._batch_fn(b, images.shape[1:3], size, identity=identity)
        res = fn(*stage_inputs(None, np.asarray(images), hws, self.device))
        return self.results_to_detections(res, thresh)

    def warmup(self, shapes=((640, 640),), size: Optional[int] = None) -> None:
        """Run the path once for each padded input shape."""
        for h, w in shapes:
            self.detect(np.zeros((h, w, 3), np.uint8), size=size)
