"""Models: ``transformer_lm`` (the flagship decoder LM), its generator
and the weight-only int8 tree."""
from autodist_tpu_torch.models.base import ModelSpec, resolve_device
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.quantize import (dequantize_lm_params,
                                                quantize_lm_params)
from autodist_tpu_torch.models.transformer_lm import (TransformerLM,
                                                      transformer_lm)

__all__ = ["ModelSpec", "resolve_device", "make_generator",
           "dequantize_lm_params", "quantize_lm_params", "TransformerLM",
           "transformer_lm"]
