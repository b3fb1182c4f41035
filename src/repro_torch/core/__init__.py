"""repro_torch.core — the paper's contribution: training-based fixed-point
quantization with on-chip-memory-only packed deployment (the reference's
``core`` package, its public names re-exported as there).

Public API:
    QuantSpec, QuantPolicy, W3A8/FLOAT/... policies
    optimal_uniform_delta / quantize / dequantize   (paper step 2)
    fake_quant / fake_quant_act / three_step_pipeline (paper steps 1+3)
    pack_int32 / unpack_int32 / pack_matrix          (on-chip storage format)
    quant_dense.{init, apply, fit_deltas, export_packed}
"""
from repro_torch.core.precision import FLOAT, TERNARY, W3A8, W4A8, W8, QuantPolicy
from repro_torch.core.quantizer import (QuantSpec, dequantize, max_level,
                                        optimal_uniform_delta, quantization_mse,
                                        quantize, quantize_levels)
from repro_torch.core.qat import (fake_quant, fake_quant_act, ste_round,
                                  three_step_pipeline)
from repro_torch.core.packing import (fields_per_word, pack_int32, pack_matrix,
                                      packed_nbytes, packed_words, unpack_int32,
                                      unpack_matrix)

__all__ = [
    "QuantSpec", "QuantPolicy", "FLOAT", "W3A8", "W4A8", "W8", "TERNARY",
    "optimal_uniform_delta", "quantize", "quantize_levels", "dequantize",
    "quantization_mse", "max_level",
    "fake_quant", "fake_quant_act", "ste_round", "three_step_pipeline",
    "pack_int32", "unpack_int32", "pack_matrix", "unpack_matrix",
    "packed_words", "packed_nbytes", "fields_per_word",
]
