"""DenseNet121 (the reference's ``examples/benchmark/imagenet.py``
DenseNet121 benchmark).

Port of ``autodist_tpu/models/densenet.py``: GroupNorm (32 groups) in place
of BatchNorm, bias-free convs.  A 7x7/s2 ``conv_init`` and a 3x3/s2 max
pool, both with XLA's asymmetric SAME pads (:func:`~autodist_tpu_torch.
models.resnet.conv`, :func:`~autodist_tpu_torch.models.resnet.
max_pool_same`); four dense blocks of ``[6, 12, 24, 16]`` layers (norm,
ReLU, 1x1 conv to ``4·growth``, norm, ReLU, 3x3 SAME conv to ``growth``,
concatenated to the input), each but the last followed by a transition
(norm, ReLU, 1x1 conv halving the channels, 2x2/s2 VALID average pool);
``norm_final``, the mean over H and W and the ``head``.  Same parameter
tree as the JAX model: conv kernels HWIO, dense kernels ``[in, out]``.
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.base import ModelSpec
from autodist_tpu_torch.models.resnet import (_image_spec, conv, dense,
                                              group_norm, max_pool_same)
from autodist_tpu_torch.models.transformer import lecun_normal
from autodist_tpu_torch.models.transformer_lm import _to_device


def _norm(c: int) -> Dict:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _kernel(k: int, c: int, o: int, gen: torch.Generator) -> Dict:
    return {"kernel": lecun_normal((k, k, c, o), k * k * c, gen)}


class DenseNet(nn.Module):
    def __init__(self, block_sizes: Sequence[int], growth_rate: int,
                 num_classes: int):
        super().__init__()
        self.block_sizes, self.growth_rate = tuple(block_sizes), growth_rate
        self.num_classes = num_classes

    def init_params(self, seed: int, device) -> Dict:
        """lecun-normal kernels (fan-in ``kh·kw·C_in``), unit norm scales,
        zero biases, drawn on the CPU from a generator seeded with
        ``seed``.  (Not JAX's random bits.)"""
        gen = torch.Generator().manual_seed(int(seed))
        g = self.growth_rate
        c = 2 * g
        params = {"conv_init": _kernel(7, 3, c, gen), "norm_init": _norm(c)}
        for i, n in enumerate(self.block_sizes):
            for j in range(n):
                params[f"block{i}_layer{j}"] = {
                    "norm1": _norm(c), "conv1": _kernel(1, c, 4 * g, gen),
                    "norm2": _norm(4 * g), "conv2": _kernel(3, 4 * g, g, gen)}
                c += g
            if i != len(self.block_sizes) - 1:
                params[f"transition{i}"] = {"norm": _norm(c),
                                            "conv": _kernel(1, c, c // 2,
                                                            gen)}
                c //= 2
        params["norm_final"] = _norm(c)
        params["head"] = {"kernel": lecun_normal((c, self.num_classes), c,
                                                 gen),
                          "bias": torch.zeros(self.num_classes)}
        return _to_device(params, device)

    def forward(self, params, images: torch.Tensor) -> torch.Tensor:
        """``images`` NHWC → logits ``[B, num_classes]``."""
        x = conv(images.permute(0, 3, 1, 2), params["conv_init"]["kernel"], 2)
        x = F.relu(group_norm(x, params["norm_init"]))
        x = max_pool_same(x, 3, 2)
        for i, n in enumerate(self.block_sizes):
            for j in range(n):
                p = params[f"block{i}_layer{j}"]
                y = F.relu(group_norm(x, p["norm1"]))
                y = conv(y, p["conv1"]["kernel"])
                y = F.relu(group_norm(y, p["norm2"]))
                x = torch.cat([x, conv(y, p["conv2"]["kernel"])], dim=1)
            if i != len(self.block_sizes) - 1:
                p = params[f"transition{i}"]
                x = conv(F.relu(group_norm(x, p["norm"])), p["conv"]["kernel"])
                x = F.avg_pool2d(x, 2, 2)
        x = F.relu(group_norm(x, params["norm_final"]))
        return dense(x.mean(dim=(2, 3)), params["head"])


def densenet121(num_classes: int = 1000, image_size: int = 224) -> ModelSpec:
    """``spec.init(seed, device=None)`` builds the parameters on
    ``device``, the CUDA card unless the caller asks for another."""
    return _image_spec("densenet121", DenseNet([6, 12, 24, 16], 32,
                                               num_classes),
                       num_classes, image_size)
