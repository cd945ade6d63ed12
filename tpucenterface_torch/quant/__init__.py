"""W8A8 post-training quantization of the port (mirrors `tpucenterface/quant/`):
the quantized engine (`engine`) and its exact int8 convolutions (`int8_ops`)."""

from tpucenterface_torch.quant.engine import QuantEngine, apply_stem_lut, stem_fixed_scale, stem_input_lut

__all__ = ["QuantEngine", "apply_stem_lut", "stem_fixed_scale", "stem_input_lut"]
