"""Models: the flagship decoder ``transformer_lm`` with its generator and
weight-only int8 tree, and the BASELINE families: ``resnet50``/``resnet101``,
``vgg16``, ``bert`` (``bert_base``, ``bert_large``) and the ``lm1b`` LSTM.
``ALL_MODELS`` holds the ported entries of the JAX package's dict
(``densenet121``, ``inception_v3`` and ``ncf`` are not ported yet)."""
from autodist_tpu_torch.models.base import ModelSpec, resolve_device
from autodist_tpu_torch.models.bert import bert, bert_base, bert_large
from autodist_tpu_torch.models.generate import make_generator
from autodist_tpu_torch.models.lm1b import lm1b
from autodist_tpu_torch.models.quantize import (dequantize_lm_params,
                                                quantize_lm_params)
from autodist_tpu_torch.models.resnet import resnet50, resnet101
from autodist_tpu_torch.models.transformer_lm import (TransformerLM,
                                                      transformer_lm)
from autodist_tpu_torch.models.vgg import vgg16

ALL_MODELS = {
    "resnet50": resnet50,
    "resnet101": resnet101,
    "vgg16": vgg16,
    "bert": bert,
    "lm1b": lm1b,
    "transformer_lm": transformer_lm,
}

__all__ = ["ModelSpec", "resolve_device", "make_generator",
           "dequantize_lm_params", "quantize_lm_params", "TransformerLM",
           "transformer_lm", "resnet50", "resnet101", "vgg16", "bert",
           "bert_base", "bert_large", "lm1b", "ALL_MODELS"]
