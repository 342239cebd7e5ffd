"""InceptionV3 (the reference's ``examples/benchmark/imagenet.py``
InceptionV3 benchmark).

Port of ``autodist_tpu/models/inception.py``: the stem, then the mixed
blocks A x 3, B, C x 4, D and E x 2 (``mixed0``–``mixed10``, Szegedy et
al. 2015), the mean over H and W and the ``head``.  Every ``ConvNorm`` is a
bias-free conv, a GroupNorm and a ReLU, its parameters under ``conv`` and
``norm``.  Three details of the JAX model are kept:

* the norm has 32 groups when the conv's filters divide by 32, else **1**
  (the 48- and 80-filter convs);
* the branch pools are ``avg_pool(3x3, s1, "SAME")`` counting the pad
  (``count_include_pad=True``, the JAX model's): the border windows divide
  by 9 too;
* the stem's max pools, the stride-2 convs of B and D and their max pools
  are VALID; every other conv is SAME, the (1, 7) and (7, 1) convs
  padding (0, 3) and (3, 0).

The block structure is written once (:meth:`InceptionV3._features`): the
init walks it on a ``meta`` image to learn each conv's input channels.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.base import ModelSpec
from autodist_tpu_torch.models.resnet import (_image_spec, conv, dense,
                                              group_norm)
from autodist_tpu_torch.models.transformer import lecun_normal
from autodist_tpu_torch.models.transformer_lm import _to_device

VALID = ((0, 0), (0, 0))


def conv_norm(p: Dict, x: torch.Tensor, stride: int = 1,
              valid: bool = False) -> torch.Tensor:
    """The JAX ``ConvNorm``: conv (SAME unless ``valid``), GroupNorm with 32
    groups when the filters divide by 32 (else 1), ReLU."""
    kernel = p["conv"]["kernel"]
    x = conv(x, kernel, stride, VALID if valid else None)
    groups = 32 if kernel.shape[-1] % 32 == 0 else 1
    return F.relu(group_norm(x, p["norm"], groups))


def _avg_pool(x: torch.Tensor) -> torch.Tensor:
    """``nn.avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")``: the pad
    counts in the mean."""
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    """``nn.max_pool(x, (3, 3), strides=(2, 2))``, VALID."""
    return F.max_pool2d(x, 3, 2)


def _block_a(cn, p, x, pool_features):
    b1 = cn(p, "b1", x, 64, (1, 1))
    b2 = cn(p, "b2_2", cn(p, "b2_1", x, 48, (1, 1)), 64, (5, 5))
    b3 = cn(p, "b3_1", x, 64, (1, 1))
    b3 = cn(p, "b3_3", cn(p, "b3_2", b3, 96, (3, 3)), 96, (3, 3))
    b4 = cn(p, "b4", _avg_pool(x), pool_features, (1, 1))
    return torch.cat([b1, b2, b3, b4], dim=1)


def _block_b(cn, p, x):
    b1 = cn(p, "b1", x, 384, (3, 3), 2, True)
    b2 = cn(p, "b2_2", cn(p, "b2_1", x, 64, (1, 1)), 96, (3, 3))
    b2 = cn(p, "b2_3", b2, 96, (3, 3), 2, True)
    return torch.cat([b1, b2, _max_pool(x)], dim=1)


def _block_c(cn, p, x, c):
    b1 = cn(p, "b1", x, 192, (1, 1))
    b2 = cn(p, "b2_2", cn(p, "b2_1", x, c, (1, 1)), c, (1, 7))
    b2 = cn(p, "b2_3", b2, 192, (7, 1))
    b3 = cn(p, "b3_2", cn(p, "b3_1", x, c, (1, 1)), c, (7, 1))
    b3 = cn(p, "b3_4", cn(p, "b3_3", b3, c, (1, 7)), c, (7, 1))
    b3 = cn(p, "b3_5", b3, 192, (1, 7))
    b4 = cn(p, "b4", _avg_pool(x), 192, (1, 1))
    return torch.cat([b1, b2, b3, b4], dim=1)


def _block_d(cn, p, x):
    b1 = cn(p, "b1_2", cn(p, "b1_1", x, 192, (1, 1)), 320, (3, 3), 2, True)
    b2 = cn(p, "b2_2", cn(p, "b2_1", x, 192, (1, 1)), 192, (1, 7))
    b2 = cn(p, "b2_4", cn(p, "b2_3", b2, 192, (7, 1)), 192, (3, 3), 2, True)
    return torch.cat([b1, b2, _max_pool(x)], dim=1)


def _block_e(cn, p, x):
    b1 = cn(p, "b1", x, 320, (1, 1))
    b2 = cn(p, "b2_1", x, 384, (1, 1))
    b2 = torch.cat([cn(p, "b2_2a", b2, 384, (1, 3)),
                    cn(p, "b2_2b", b2, 384, (3, 1))], dim=1)
    b3 = cn(p, "b3_2", cn(p, "b3_1", x, 448, (1, 1)), 384, (3, 3))
    b3 = torch.cat([cn(p, "b3_3a", b3, 384, (1, 3)),
                    cn(p, "b3_3b", b3, 384, (3, 1))], dim=1)
    b4 = cn(p, "b4", _avg_pool(x), 192, (1, 1))
    return torch.cat([b1, b2, b3, b4], dim=1)


#: the mixed blocks in order: name, block, its extra argument
MIXED = [("mixed0", _block_a, 32), ("mixed1", _block_a, 64),
         ("mixed2", _block_a, 64), ("mixed3", _block_b, None),
         ("mixed4", _block_c, 128), ("mixed5", _block_c, 160),
         ("mixed6", _block_c, 160), ("mixed7", _block_c, 192),
         ("mixed8", _block_d, None), ("mixed9", _block_e, None),
         ("mixed10", _block_e, None)]


def _apply(p, name, x, filters, kernel, stride=1, valid=False):
    return conv_norm(p[name], x, stride, valid)


class InceptionV3(nn.Module):
    #: the smallest input that reaches ``mixed10`` (a 1x1 map there)
    MIN_SIZE = 75

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes

    @staticmethod
    def _features(cn: Callable, params: Dict, x: torch.Tensor
                  ) -> torch.Tensor:
        """The stem and the mixed blocks on NCHW ``x``; ``cn(p, name, x,
        filters, kernel, stride=1, valid=False)`` runs (or builds) the
        ``ConvNorm`` ``p[name]``."""
        x = cn(params, "stem1", x, 32, (3, 3), 2, True)
        x = cn(params, "stem2", x, 32, (3, 3), 1, True)
        x = _max_pool(cn(params, "stem3", x, 64, (3, 3)))
        x = cn(params, "stem4", x, 80, (1, 1), 1, True)
        x = _max_pool(cn(params, "stem5", x, 192, (3, 3), 1, True))
        for name, block, arg in MIXED:
            p = params.setdefault(name, {})
            x = block(cn, p, x) if arg is None else block(cn, p, x, arg)
        return x

    def init_params(self, seed: int, device) -> Dict:
        """lecun-normal kernels (fan-in ``kh·kw·C_in``), unit norm scales,
        zero biases, drawn on the CPU from a generator seeded with
        ``seed`` in the blocks' order.  (Not JAX's random bits.)"""
        gen = torch.Generator().manual_seed(int(seed))

        def build(p, name, x, filters, kernel, stride=1, valid=False):
            kh, kw = kernel
            c = x.shape[1]
            p[name] = {"conv": {"kernel": lecun_normal(
                (kh, kw, c, filters), kh * kw * c, gen)},
                "norm": {"scale": torch.ones(filters),
                         "bias": torch.zeros(filters)}}
            return conv(x, torch.empty((kh, kw, c, filters), device="meta"),
                        stride, VALID if valid else None)

        params: Dict = {}
        x = self._features(build, params, torch.empty(
            (1, 3, self.MIN_SIZE, self.MIN_SIZE), device="meta"))
        c = x.shape[1]
        params["head"] = {"kernel": lecun_normal((c, self.num_classes), c,
                                                 gen),
                          "bias": torch.zeros(self.num_classes)}
        return _to_device(params, device)

    def forward(self, params, images: torch.Tensor) -> torch.Tensor:
        """``images`` NHWC → logits ``[B, num_classes]``."""
        x = self._features(_apply, params, images.permute(0, 3, 1, 2))
        return dense(x.mean(dim=(2, 3)), params["head"])


def inception_v3(num_classes: int = 1000, image_size: int = 299
                 ) -> ModelSpec:
    """``image_size`` 299 is InceptionV3's published input and the JAX
    factory's default; 75 is the smallest that reaches ``mixed10``."""
    return _image_spec("inception_v3", InceptionV3(num_classes),
                       num_classes, image_size)
