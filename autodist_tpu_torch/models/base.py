"""Model plumbing: :class:`ModelSpec`, device resolution, shared math.

Port of ``autodist_tpu/models/base.py``.  Parameters are plain nested
dicts of tensors keyed exactly like the JAX package's parameter tree
(``decoder/layers_0/attn/query/kernel`` is
``params["decoder"]["layers_0"]["attn"]["query"]["kernel"]``), so a
logical name means the same tensor in both packages and a weight-only
int8 tree can swap a leaf for a ``Quantized`` pair without changing the
block math.  Modules hold no parameters; they take the tree explicitly,
the functional ``apply`` idiom of the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict

import torch
import torch.nn.functional as F


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    the CUDA card.  With no device given and no CUDA present this raises
    instead of carrying on silently on the CPU.

    On CUDA it also turns TF32 off for matmuls and cuDNN, explicitly:
    the model is float32, and the serving engine must stay token-exact
    with its reference generator (TF32 keeps about three digits)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' explicitly to "
                "run the port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is "
                               f"not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


@dataclass
class ModelSpec:
    """Everything the serving and training paths need about one model."""

    name: str
    init: Callable                 # (seed, device=None) -> params
    loss_fn: Callable              # (params, batch) -> scalar loss
    apply_fn: Callable             # (params, inputs) -> outputs
    make_batch: Callable           # (rng, batch_size) -> batch dict
    config: Dict[str, Any] = field(default_factory=dict)


def layer_norm(x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Bias-free layer norm with eps 1e-6 (the JAX package's ``LayerNorm(
    use_bias=False)``; torch's default would be eps 1e-5 with a bias)."""
    return F.layer_norm(x, (x.shape[-1],), weight=scale, bias=None, eps=eps)


def cross_entropy_loss(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels."""
    logz = torch.log_softmax(logits, dim=-1)
    return -logz.gather(-1, labels.long()[..., None]).mean()
