"""The system under test: the port's `Detector`, built from a configuration
file as that file states it. The only module of the benchmark that imports
the program, with the entries (`entries/detect_tta.py` imports the TTA
runner where it runs it)."""

from __future__ import annotations

from tpucenterface_torch.config import DecodeConfig, DetectorConfig, ModelConfig, PreprocessConfig
from tpucenterface_torch.detector import Detector


def detector_config(cfg: dict) -> DetectorConfig:
    prog, pp = cfg["program"], cfg["preprocess"]
    model = ModelConfig(
        inverted_residual_setting=tuple(tuple(r) for r in cfg["inverted_residual_setting"]),
        stem_channels=cfg["stem_channels"], width_mult=cfg["width_mult"], fpn_channels=cfg["fpn_channels"],
        head_conv=cfg["head_conv"], num_classes=cfg["num_classes"], with_landmarks=cfg["with_landmarks"],
        relu6=cfg["relu6"], bn_eps=cfg["bn_eps"], hm_bias_init=cfg["hm_bias_init"],
        compute_dtype=cfg["compute_dtype"], inference_engine=prog["inference_engine"],
    )
    decode = DecodeConfig(stride=cfg["stride"], max_dets=cfg["max_dets"], wh_log=cfg["wh_log"],
                          use_pallas=prog["use_pallas"], lm_flip_perm=tuple(cfg["lm_flip_perm"]))
    preprocess = PreprocessConfig(mean=tuple(pp["mean"]), std=tuple(pp["std"]), bgr_input=pp["bgr_input"],
                                  center=pp["center"])
    return DetectorConfig(model=model, decode=decode, preprocess=preprocess, buckets=tuple(cfg["buckets"]))


def build(cfg: dict, variables: dict, device) -> Detector:
    """The Detector of `cfg` on the raw `variables`; it folds BatchNorm and
    bakes the normalisation into the stem itself."""
    return Detector(variables=variables, config=detector_config(cfg), device=device,
                    fold_bn=cfg["program"]["fold_bn"])
