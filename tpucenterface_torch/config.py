"""Frozen configuration dataclasses of the PyTorch port.

Mirrors `tpucenterface/config.py` (`ModelConfig`, `DecodeConfig`,
`PreprocessConfig`, `DetectorConfig`, `preset`, `TrainConfig`,
`DEFAULT_BUCKETS`, `INPUT_PAD_MULTIPLE`) field for field, with the same names and defaults, so a
config built for one package means the same model in the other. The JAX
package's field comments carry the measurements behind each default; they were
taken on a TPU and are not repeated here.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture of backbone + neck + heads."""

    # MobileNetV2 inverted-residual settings: (expand_t, channels, repeats, stride)
    inverted_residual_setting: Tuple[Tuple[int, int, int, int], ...] = (
        (1, 16, 1, 1),
        (6, 24, 2, 2),   # -> stride 4 skip
        (6, 32, 3, 2),   # -> stride 8 skip
        (6, 64, 4, 2),
        (6, 96, 3, 1),   # -> stride 16 skip
        (6, 160, 3, 2),
        (6, 320, 1, 1),  # -> stride 32 top
    )
    stem_channels: int = 32
    width_mult: float = 1.0
    fpn_channels: int = 24
    head_conv: int = 24         # hidden width of each head's 3x3 conv; 0 = single 1x1
    num_classes: int = 1
    with_landmarks: bool = False
    relu6: bool = True
    bn_eps: float = 1e-5
    bn_momentum: float = 0.9
    # Prior-probability init of the heatmap head bias: -log((1-p)/p), p=0.01.
    hm_bias_init: float = -4.59511985013459
    # Conv compute dtype; heads always emit float32.
    compute_dtype: str = "bfloat16"
    # Dtype of the normalized activations on the unfolded (BatchNorm) path.
    bn_compute_dtype: str = "float32"
    # BatchNorm pre-folded into conv kernel/bias (weights.fold.fold_variables).
    folded: bool = False
    # Head branches merged into one wide conv + block-diagonal 1x1.
    fused_heads: bool = False
    # Space-to-depth stem: a 2x space-to-depth of the input and a 2x2/s1
    # conv in place of the 3x3/s2 stem (the same function after
    # weights.fold.s2d_remap_stem); needs even input sides.
    s2d_stem: bool = False
    # Input normalization baked into the folded stem conv: the model is fed
    # mean-centered raw pixels `u - 255*mean`.
    stem_preprocess: bool = False
    # Forward implementation: 'flax' is the module forward (the name is the
    # JAX package's, kept so configs carry across); 'fast' is
    # model.fast_forward.FastEngine with the fused MBConv kernel.
    inference_engine: str = "flax"

    def width(self, c: int) -> int:
        """Width multiplier with the MobileNet `_make_divisible` rule."""
        if self.width_mult == 1.0:
            return c
        scaled = c * self.width_mult
        v = max(8, int(scaled + 4) // 8 * 8)
        if v < 0.9 * scaled:
            v += 8
        return v


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """CenterNet decode: sigmoid -> 3x3 maxpool pseudo-NMS -> top-k -> gather."""

    stride: int = 4
    max_dets: int = 200          # K of the top-k peak extraction
    score_thresh: float = 0.35
    # If True, box sizes are exp(wh); if False, raw wh clamped at >= 0.
    wh_log: bool = False
    # Fused decode kernel (decode.fused_decode) instead of the reference decode.
    use_pallas: bool = False
    lm_flip_perm: Tuple[int, ...] = (1, 0, 2, 4, 3)
    # Two-stage top-k (decode.reference.topk_2stage): same values as a full
    # top-k; exactly tied scores are ordered by chunk rank.
    fast_topk: bool = True


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Device-side letterbox + mean/std normalization."""

    mean: Tuple[float, float, float] = (0.408, 0.447, 0.470)
    std: Tuple[float, float, float] = (0.289, 0.274, 0.278)
    bgr_input: bool = True
    center: bool = True
    method: str = "bilinear"
    # 'matmul': the bilinear letterbox as two products; any other value:
    # jax.image.scale_and_translate's resize with `method`, in float32
    resize_impl: str = "matmul"
    resize_dtype: str = "bfloat16"
    stem_bake: bool = True
    identity_fast_path: bool = True


def dtype_of(name: str) -> torch.dtype:
    """The torch dtype a config names ('bfloat16', 'float32', ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a torch dtype: {name}")
    return dt


def resolve_device(device=None) -> torch.device:
    """The GPU unless `device` names another; raises when the GPU is asked
    for and there is none (nothing falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


# Square model input sizes of the resolution buckets.
DEFAULT_BUCKETS: Tuple[int, ...] = (320, 416, 512, 640, 800, 1024)

# Host-side input images are zero-padded up to multiples of this.
INPUT_PAD_MULTIPLE: int = 128


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    model: ModelConfig = ModelConfig()
    decode: DecodeConfig = DecodeConfig()
    preprocess: PreprocessConfig = PreprocessConfig()
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    default_size: int = 640


def preset(name: str) -> DetectorConfig:
    """Named model-size presets: 'default' (width 1.0) / 'small' (0.5) /
    'large' (1.4, 48ch FPN)."""
    if name == "default":
        return DetectorConfig()
    if name == "small":
        return DetectorConfig(model=ModelConfig(width_mult=0.5))
    if name == "large":
        return DetectorConfig(
            model=ModelConfig(width_mult=1.4, fpn_channels=48, head_conv=48)
        )
    raise KeyError(f"unknown preset '{name}' (default|small|large)")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """CenterNet training hyperparameters (`tpucenterface/config.py:236-290`)."""

    input_size: int = 640
    batch_size: int = 32
    lr: float = 5e-4
    lr_drops: Tuple[int, ...] = (90, 120)   # epochs at which the LR drops
    lr_drop_factor: float = 0.1
    epochs: int = 140
    weight_decay: float = 0.0
    hm_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0
    lm_weight: float = 0.1
    # render landmark targets from the records' GT (pair with
    # ModelConfig.with_landmarks); records without landmarks give lm_mask=0
    with_landmarks: bool = False
    focal_alpha: float = 2.0
    focal_beta: float = 4.0
    max_objs: int = 128          # per-image cap on rendered GT boxes
    # recompute the forward's activations in the backward pass
    # (torch.utils.checkpoint): activation memory for operations
    remat: bool = False
    # exponential moving average of the params (0 = off), updated inside
    # the step as ema = d*ema + (1-d)*params; exported as
    # model_ema.safetensors beside the live weights
    ema_decay: float = 0.0
    # global-norm gradient clipping ahead of Adam (0 = off)
    grad_clip_norm: float = 0.0
    # FrozenBN boundary (0 = off): from this step on BatchNorm normalizes
    # with its running averages and the statistics stop updating, so train
    # and eval normalization are the same for the rest of the run
    freeze_bn_steps: int = 0
    # augmentation
    scale_range: Tuple[float, float] = (0.6, 1.4)
    shift_ratio: float = 0.1
    flip_prob: float = 0.5
    color_jitter: float = 0.4
