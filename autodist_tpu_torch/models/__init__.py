"""Models: the flagship decoder ``transformer_lm`` with its generator and
weight-only int8 tree, and the reference's benchmark families:
``resnet50``/``resnet101``, ``vgg16``, ``densenet121``, ``inception_v3``,
``bert`` (``bert_base``, ``bert_large``), the ``lm1b`` LSTM and ``ncf``.
``ALL_MODELS`` is the JAX package's dict.  The LoRA helpers, the
speculative generator, the expert-parallel ``moe_transformer_lm`` and the
pipelined ``pipelined_transformer_lm`` and ``pipelined_moe_transformer_lm``
are ported too."""
from autodist_tpu_torch.models.base import (ModelSpec, cross_entropy_loss,
                                            resolve_device)
from autodist_tpu_torch.models.bert import bert, bert_base, bert_large
from autodist_tpu_torch.models.densenet import densenet121
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.inception import inception_v3
from autodist_tpu_torch.models.lm1b import lm1b
from autodist_tpu_torch.models.lora import lora_init, lora_merge, lora_setup
from autodist_tpu_torch.models.moe_lm import moe_transformer_lm
from autodist_tpu_torch.models.ncf import ncf
from autodist_tpu_torch.models.pipelined_lm import pipelined_transformer_lm
from autodist_tpu_torch.models.pipelined_moe_lm import \
    pipelined_moe_transformer_lm
from autodist_tpu_torch.models.quantize import (dequantize_lm_params,
                                                quantize_lm_params)
from autodist_tpu_torch.models.resnet import resnet50, resnet101
from autodist_tpu_torch.models.speculative import make_speculative_generator
from autodist_tpu_torch.models.transformer_lm import (TransformerLM,
                                                      transformer_lm)
from autodist_tpu_torch.models.vgg import vgg16

ALL_MODELS = {
    "resnet50": resnet50,
    "resnet101": resnet101,
    "vgg16": vgg16,
    "densenet121": densenet121,
    "inception_v3": inception_v3,
    "bert": bert,
    "lm1b": lm1b,
    "ncf": ncf,
    "transformer_lm": transformer_lm,
}

__all__ = ["ModelSpec", "resolve_device", "cross_entropy_loss",
           "make_generator", "dequantize_lm_params", "quantize_lm_params",
           "TransformerLM", "transformer_lm", "resnet50", "resnet101",
           "vgg16", "densenet121", "inception_v3", "bert", "bert_base",
           "bert_large", "lm1b", "ncf", "lora_init", "lora_merge",
           "lora_setup", "make_speculative_generator", "moe_transformer_lm",
           "pipelined_transformer_lm", "pipelined_moe_transformer_lm",
           "ALL_MODELS"]
