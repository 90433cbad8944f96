"""Weight quantization (port of ``vision_pt_tpu/ops/quant``); the fused
4-bit dequant-matmul is ``nf4_matmul`` over ``csrc/nf4_matmul.cu``."""

from .functional import (
    QUANT_TYPE,
    detect_quant_type,
    quantize_inplace,
    quantize_state_dict,
    replace_by_prequantized_weights,
    replace_to_quant_linear,
)
from .layers import QuantLinear4bit, QuantLinearFP8, QuantLinearInt8
from .nf4 import dequantize_4bit, quantize_4bit

__all__ = [
    "QUANT_TYPE",
    "quantize_4bit",
    "dequantize_4bit",
    "QuantLinear4bit",
    "QuantLinearInt8",
    "QuantLinearFP8",
    "replace_to_quant_linear",
    "quantize_inplace",
    "replace_by_prequantized_weights",
    "quantize_state_dict",
    "detect_quant_type",
]
