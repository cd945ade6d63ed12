"""The system under test for architecture `mobilenetv2`: the port's
`Detector`, built from a configuration file as that file states it. With
the entries (`entries/detect_tta.py` imports the TTA runner where it runs
it), `programs/` is the only part of the benchmark that imports the program.

`detector_config` refuses a key it does not build, so that no configuration
runs as another model under its name."""

from __future__ import annotations

from tpucenterface_torch.config import DecodeConfig, DetectorConfig, ModelConfig, PreprocessConfig
from tpucenterface_torch.detector import Detector

# every key a configuration file may hold, by the group it sits in
KNOWN_KEYS = {"architecture", "name", "source", "description", "reduced", "assumed", "inverted_residual_setting",
              "stem_channels", "width_mult", "fpn_channels", "head_conv", "num_classes", "with_landmarks", "relu6",
              "bn_eps", "hm_bias_init", "compute_dtype", "stride", "max_dets", "wh_log", "lm_flip_perm", "buckets",
              "preprocess", "program"}
KNOWN_GROUP_KEYS = {"preprocess": {"mean", "std", "bgr_input", "center"},
                    "program": {"inference_engine", "use_pallas", "fold_bn"}}


def refuse_unknown(cfg: dict) -> None:
    """Raise where `cfg`, or one of its groups, holds a key this program
    does not build."""
    unknown = set(cfg) - KNOWN_KEYS
    for group, keys in KNOWN_GROUP_KEYS.items():
        unknown |= {f"{group}.{k}" for k in set(cfg.get(group, ())) - keys}
    if unknown:
        raise ValueError(f"the {cfg.get('architecture')} program does not build the configuration keys "
                         f"{sorted(unknown)}")


def detector_config(cfg: dict) -> DetectorConfig:
    refuse_unknown(cfg)
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
