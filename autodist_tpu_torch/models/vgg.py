"""VGG16 (the reference's ``examples/benchmark/imagenet.py`` VGG16, the
PartitionedPS showcase: its huge fc layers are what variable partitioning
was built for).

Port of ``autodist_tpu/models/vgg.py``: thirteen 3x3 SAME convs with
biases and ReLU, VALID 2x2/s2 max pools, then ``fc1``, ``fc2`` and
``head``.  The JAX model flattens NHWC, so ``fc1``'s rows are in
``(h, w, c)`` order: the features go back to NHWC before the reshape.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.base import ModelSpec
from autodist_tpu_torch.models.resnet import _image_spec, conv, dense
from autodist_tpu_torch.models.transformer import lecun_normal
from autodist_tpu_torch.models.transformer_lm import _to_device

_CFG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"]


class VGG(nn.Module):
    def __init__(self, num_classes: int, image_size: int = 224):
        super().__init__()
        self.num_classes, self.image_size = num_classes, image_size

    def init_params(self, seed: int, device) -> Dict:
        """lecun-normal kernels, zero biases (the JAX model's defaults),
        drawn on the CPU from a generator seeded with ``seed``.  ``fc1``'s
        fan-in is the flattened features of an ``image_size`` input."""
        gen = torch.Generator().manual_seed(int(seed))
        params, c, side, idx = {}, 3, self.image_size, 0
        for v in _CFG16:
            if v == "M":
                side //= 2
                continue
            params[f"conv{idx}"] = {
                "kernel": lecun_normal((3, 3, c, v), 9 * c, gen),
                "bias": torch.zeros(v)}
            c, idx = v, idx + 1
        for name, fan_in, out in (("fc1", side * side * c, 4096),
                                  ("fc2", 4096, 4096),
                                  ("head", 4096, self.num_classes)):
            params[name] = {"kernel": lecun_normal((fan_in, out), fan_in, gen),
                            "bias": torch.zeros(out)}
        return _to_device(params, device)

    def forward(self, params, images: torch.Tensor) -> torch.Tensor:
        """``images`` NHWC → logits ``[B, num_classes]``."""
        x = images.permute(0, 3, 1, 2)
        idx = 0
        for v in _CFG16:
            if v == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                p = params[f"conv{idx}"]
                x = F.relu(conv(x, p["kernel"], bias=p["bias"]))
                idx += 1
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC order
        x = F.relu(dense(x, params["fc1"]))
        x = F.relu(dense(x, params["fc2"]))
        return dense(x, params["head"])


def vgg16(num_classes: int = 1000, image_size: int = 224) -> ModelSpec:
    return _image_spec("vgg16", VGG(num_classes, image_size), num_classes,
                       image_size)
