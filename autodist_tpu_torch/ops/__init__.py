"""Kernels with their plain versions: paged attention and the int8
matmul (CUDA sources under ``csrc/``)."""
from autodist_tpu_torch.ops.fused_kernels import (paged_attention,
                                                  paged_attention_reference)
from autodist_tpu_torch.ops.quant import (Quantized, int8_matmul,
                                          int8_matmul_reference,
                                          quantize_weight)

__all__ = ["paged_attention", "paged_attention_reference", "Quantized",
           "int8_matmul", "int8_matmul_reference", "quantize_weight"]
