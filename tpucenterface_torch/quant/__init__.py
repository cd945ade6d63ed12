"""Int8 quantization of the port (mirrors `tpucenterface/quant/`): the
quantized engine (`engine`), its exact int8 convolutions (`int8_ops`), and the
label-free fine-tuning of its weights, AdaRound (`adaround`) and QAT
(`qat`)."""

from tpucenterface_torch.quant.adaround import adaround
from tpucenterface_torch.quant.engine import QuantEngine, apply_stem_lut, stem_fixed_scale, stem_input_lut
from tpucenterface_torch.quant.qat import qat_finetune

__all__ = ["QuantEngine", "adaround", "apply_stem_lut", "qat_finetune", "stem_fixed_scale", "stem_input_lut"]
