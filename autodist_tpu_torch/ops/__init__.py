"""Kernels with their plain versions: flash attention (forward, dQ, dK/dV;
``flash_attention`` and ``make_flash_attention`` as the JAX package exports
them, so the name resolves to the function and the module loads with
``importlib.import_module("autodist_tpu_torch.ops.flash_attention")``),
the guard statistics and the fused ZeRO-1 Adam update (in
:mod:`autodist_tpu_torch.ops.fused_kernels`), paged attention and the
int8 matmul (CUDA sources under ``csrc/``); and the vocabulary losses,
plain PyTorch as in the JAX package: the chunked exact and the sampled
softmax cross entropy."""
from autodist_tpu_torch.ops.chunked_xent import chunked_softmax_cross_entropy
from autodist_tpu_torch.ops.flash_attention import (flash_attention,
                                                    make_flash_attention)
from autodist_tpu_torch.ops.fused_kernels import (paged_attention,
                                                  paged_attention_reference)
from autodist_tpu_torch.ops.quant import (Quantized, int8_matmul,
                                          int8_matmul_reference,
                                          quantize_weight)
from autodist_tpu_torch.ops.sampled_xent import sampled_softmax_cross_entropy

__all__ = ["flash_attention", "make_flash_attention", "paged_attention",
           "paged_attention_reference", "Quantized", "int8_matmul",
           "int8_matmul_reference", "quantize_weight",
           "chunked_softmax_cross_entropy", "sampled_softmax_cross_entropy"]
