"""Detector API: `detect(image) -> Detections(boxes, scores, landmarks)`.

Mirrors `tpucenterface/detector.py::Detections` and `Detector` (`__init__`,
`from_safetensors`, `_decode`, `_forward`, `results_to_detections`,
`_identity_for`, `detect`, `detect_batch`, `warmup`):

    host:   zero-pad the frame to a shape bucket, copy to the device
    device: letterbox+normalize -> backbone -> neck -> heads -> decode
            -> inverse letterbox
    host:   threshold filter of the fixed-K result

Construction folds BatchNorm, fuses the heads and bakes the input normalize
into the stem as the JAX Detector does. Everything runs eagerly. The device is
the GPU unless the caller passes another; asking for the GPU on a machine
without one raises.

Not ported yet: `quantize`, `reload_weights`, the flip-TTA batch program,
the planar engine and the space-to-depth stem.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from tpucenterface_torch.config import DetectorConfig
from tpucenterface_torch.decode.fused_decode import decode_feats_fused
from tpucenterface_torch.decode.reference import (
    boxes_to_original,
    decode_feats_with_idx,
    decode_landmarks,
    landmarks_to_original,
)
from tpucenterface_torch.model.centernet import CenterFaceNet, init_model
from tpucenterface_torch.preprocess import (
    letterbox_normalize_batch,
    normalize_images,
    pad_to_bucket,
)
from tpucenterface_torch.weights.convert import state_dict_from_variables
from tpucenterface_torch.weights.fold import fold_variables
from tpucenterface_torch.weights.io import load_safetensors


class Detections(NamedTuple):
    """Typed detect() result; `landmarks` is None without the landmark head."""

    boxes: np.ndarray              # (N, 4) [x1,y1,x2,y2] original-image px
    scores: np.ndarray             # (N,) float32, descending
    landmarks: Optional[np.ndarray] = None  # (N, 5, 2) or None


def resolve_device(device=None) -> torch.device:
    """The GPU unless `device` names another; raises when the GPU is asked
    for and there is none (nothing falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


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
        self.config = config
        if variables is None:
            _, variables = init_model(config.model, seed=seed)
        if fold_bn and not config.model.folded and "batch_stats" in variables:
            stem_kh = int(np.shape(variables["params"]["backbone"]["stem"]["conv"]["kernel"])[0])
            if config.model.s2d_stem or stem_kh != 3:
                raise NotImplementedError("the port has no space-to-depth stem yet")
            fuse = config.model.head_conv > 0
            bake = config.preprocess.stem_bake
            variables = fold_variables(
                variables,
                bn_eps=config.model.bn_eps,
                fuse_heads=fuse,
                bake_preprocess=config.preprocess if bake else None,
            )
            self.config = dataclasses.replace(
                config,
                model=dataclasses.replace(
                    config.model, folded=True, fused_heads=fuse, stem_preprocess=bake
                ),
            )
        self.variables = variables
        self.model = CenterFaceNet(self.config.model)
        self.model.load_state_dict(state_dict_from_variables(variables), strict=True)
        self.model.requires_grad_(False).eval().cast_convs_()
        self.model.to(device=self.device, memory_format=torch.channels_last)

    @classmethod
    def from_safetensors(
        cls, path: str, config: DetectorConfig = DetectorConfig(), device=None
    ) -> "Detector":
        return cls(variables=load_safetensors(path), config=config, device=device)

    # ------------------------------------------------------------------ #
    # the device path
    # ------------------------------------------------------------------ #

    def _decode(self, feats: Dict[str, torch.Tensor]):
        """-> (boxes, scores, landmarks-or-None), all in model-input pixels.
        The fused decode kernel runs when `use_pallas` is set and the model
        has no landmark head; K = min(max_dets, H*W) on both routes."""
        cfg = self.config.decode
        if cfg.use_pallas and "lm" not in feats:
            boxes, scores, _ = decode_feats_fused(feats, cfg)
            return boxes, scores, None
        boxes, scores, idx = decode_feats_with_idx(feats, cfg)
        lm = decode_landmarks(feats, idx, cfg) if "lm" in feats else None
        return boxes, scores, lm

    def _forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.model(x)

    def _run(self, images: np.ndarray, hws: np.ndarray, size: int, identity: bool):
        """(B, Hp, Wp, 3) uint8 + (B, 2) content sizes -> (boxes, scores[, lm])
        device tensors in original-image pixels."""
        raw = self.config.model.stem_preprocess
        pp = self.config.preprocess
        with torch.inference_mode():
            imgs = torch.from_numpy(np.ascontiguousarray(images, np.uint8)).to(self.device)
            hw = torch.from_numpy(np.asarray(hws, np.int32)).to(self.device)
            b = imgs.shape[0]
            if identity:
                x = normalize_images(imgs, pp, raw=raw)
                scales = torch.ones((b,), dtype=torch.float32, device=self.device)
                pads = torch.zeros((b, 2), dtype=torch.float32, device=self.device)
            else:
                x, scales, pads = letterbox_normalize_batch(imgs, hw, size, pp, raw=raw)
            feats = self._forward(x)
            boxes, scores, lm = self._decode(feats)
            boxes = boxes_to_original(boxes, scales, pads, hw)
            if lm is not None:
                return boxes, scores, landmarks_to_original(lm, scales, pads, hw)
            return boxes, scores

    def _identity_for(self, padded_hw, size: int, hws) -> bool:
        """True when every image in the call is exactly the model size, so
        the letterbox is the identity (PreprocessConfig.identity_fast_path)."""
        return (
            self.config.preprocess.identity_fast_path
            and tuple(padded_hw) == (size, size)
            and bool((np.asarray(hws) == size).all())
        )

    def results_to_detections(self, res, thresh: float) -> List[Detections]:
        """Split a (boxes, scores[, landmarks]) tensor result into per-image
        thresholded `Detections`."""
        boxes, scores = res[0].cpu().numpy(), res[1].cpu().numpy()
        lms = res[2].cpu().numpy() if len(res) == 3 else None
        out: List[Detections] = []
        for i in range(boxes.shape[0]):
            keep = scores[i] >= thresh
            out.append(
                Detections(boxes[i][keep], scores[i][keep], lms[i][keep] if lms is not None else None)
            )
        return out

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
        `score_thresh`."""
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"detect() expects an HxWx3 color image, got shape {image.shape}")
        thresh = self.config.decode.score_thresh if score_thresh is None else score_thresh
        size = size or self.config.default_size
        h, w = image.shape[:2]
        padded = pad_to_bucket(image)
        identity = self._identity_for(padded.shape[:2], size, (h, w))
        res = self._run(padded[None], np.array([[h, w]], np.int32), size, identity)
        return self.results_to_detections(res, thresh)[0]

    def detect_batch(
        self,
        images: np.ndarray,
        hws: Optional[np.ndarray] = None,
        score_thresh: Optional[float] = None,
        size: Optional[int] = None,
    ) -> List[Detections]:
        """Batched detect over images of one padded shape (B, Hp, Wp, 3)
        uint8; `hws` (B, 2) gives each image's content size (default: the
        whole padded shape)."""
        thresh = self.config.decode.score_thresh if score_thresh is None else score_thresh
        size = size or self.config.default_size
        b = images.shape[0]
        if hws is None:
            hws = np.tile(np.array(images.shape[1:3], np.int32), (b, 1))
        identity = self._identity_for(images.shape[1:3], size, hws)
        res = self._run(images, hws, size, identity)
        return self.results_to_detections(res, thresh)

    def warmup(self, shapes=((640, 640),), size: Optional[int] = None) -> None:
        """Run the path once for each padded input shape."""
        for h, w in shapes:
            self.detect(np.zeros((h, w, 3), np.uint8), size=size)
