"""ResNet for image classification.

Port of ``autodist_tpu/models/resnet.py``: bottleneck blocks with
GroupNorm (32 groups, eps 1e-6, ``scale``/``bias``) in place of BatchNorm,
bias-free convs, a ``Dense`` head after the mean over H and W, and the
``conv7`` or space-to-depth (``s2d``) stem.  Same defaults, config keys
and parameter tree as the JAX factory: conv kernels HWIO ``[kh, kw,
C_in, C_out]``, dense kernels ``[in, out]``.

Inputs arrive NHWC (as ``make_batch`` draws them) and go to NCHW once at
the model's entry; each conv permutes its kernel to OIHW at the call.
XLA's SAME padding is asymmetric where torch's ``padding=`` is not: for a
stride-2 window it pads ``lo = total // 2`` and ``hi = total - lo`` (the
7x7/s2 stem (2, 3), each stage's first 3x3/s2 conv and the 3x3/s2 max
pool (0, 1) on even inputs), so :func:`conv` and
:func:`max_pool_same` pad explicitly.  The convs, norms and pools are
PyTorch calls: the JAX package has no Pallas kernel here.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.base import (ModelSpec, cross_entropy_loss,
                                            resolve_device, tree_device)
from autodist_tpu_torch.models.transformer import lecun_normal
from autodist_tpu_torch.models.transformer_lm import _to_device

GROUPS = 32
NORM_EPS = 1e-6


def same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: ``(lo, hi)``."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
         pads=None, bias=None) -> torch.Tensor:
    """``x`` NCHW against an HWIO ``kernel``; ``pads`` ``((top, bottom),
    (left, right))``, SAME when None."""
    kh, kw = kernel.shape[:2]
    if pads is None:
        pads = (same_pads(x.shape[2], kh, stride),
                same_pads(x.shape[3], kw, stride))
    (t, b), (lf, r) = pads
    w = kernel.permute(3, 2, 0, 1)
    if t == b and lf == r:
        return F.conv2d(x, w, bias, stride, (t, lf))
    return F.conv2d(F.pad(x, (lf, r, t, b)), w, bias, stride)


def max_pool_same(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), (stride, stride), "SAME")`` on NCHW: the
    pad is -inf."""
    (t, b), (lf, r) = (same_pads(x.shape[2], k, stride),
                       same_pads(x.shape[3], k, stride))
    x = F.pad(x, (lf, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, k, stride)


def group_norm(x: torch.Tensor, p: Dict, groups: int = GROUPS
               ) -> torch.Tensor:
    """The JAX model's ``GroupNorm(num_groups=groups)`` (eps 1e-6) on
    NCHW."""
    return F.group_norm(x, groups, p["scale"], p["bias"], NORM_EPS)


def dense(x: torch.Tensor, p: Dict) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC ``[B, H, W, C]`` → ``[B, H/b, W/b, b·b·C]``, channels packed
    ``(dy, dx, c)``."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // block, w // block, block * block * c)


def convert_stem_params(params):
    """Losslessly remap a ``stem='conv7'`` tree to ``stem='s2d'``: the
    ``[7, 7, C, 64]`` kernel embedded in the ``[4, 4, 4C, 64]`` layout, so
    the s2d model computes the SAME function.  With SAME's (2, 3) pad of
    the 7x7/s2 conv, ``out[i, j] = Σ W7[u, v, c] · x[2i+u-2, 2j+v-2, c]``;
    writing ``2i+u-2 = 2(i+a)+dy`` gives ``u = 2a+dy+2`` with ``a`` in
    -1..2 and ``dy`` in {0, 1}: a 4x4 conv over s2d input with padding
    (1, 2) and kernel entry ``(a+1, b+1, (dy, dx, c)) = W7[2a+dy+2,
    2b+dx+2]`` (zero outside 0..6).  Numpy arithmetic, as the JAX
    function's; leaves of any array type, the new kernel a tensor on the
    old one's device (numpy for numpy)."""
    old = params["conv_init"]["kernel"]
    w7 = old.detach().cpu().numpy() if isinstance(old, torch.Tensor) \
        else np.asarray(old)
    c_in, c_out = w7.shape[2], w7.shape[3]
    w4 = np.zeros((4, 4, 4 * c_in, c_out), w7.dtype)
    for a2 in range(4):
        for b2 in range(4):
            for dy in range(2):
                for dx in range(2):
                    r = 2 * a2 + dy
                    s = 2 * b2 + dx
                    if r < 7 and s < 7:
                        ch = (dy * 2 + dx) * c_in
                        w4[a2, b2, ch:ch + c_in] = w7[r, s]
    out = dict(params)
    out["conv_init"] = {"kernel": torch.from_numpy(w4).to(old.device)
                        if isinstance(old, torch.Tensor) else w4}
    return out


class BottleneckBlock(nn.Module):
    def __init__(self, filters: int, strides: int = 1, proj: bool = False):
        super().__init__()
        self.filters, self.strides, self.proj = filters, strides, proj

    def init(self, c_in: int, gen: torch.Generator) -> Dict:
        f = self.filters

        def kernel(kh, c, o):
            return {"kernel": lecun_normal((kh, kh, c, o), kh * kh * c, gen)}

        def norm(c):
            return {"scale": torch.ones(c), "bias": torch.zeros(c)}

        p = {"conv1": kernel(1, c_in, f), "norm1": norm(f),
             "conv2": kernel(3, f, f), "norm2": norm(f),
             "conv3": kernel(1, f, 4 * f), "norm3": norm(4 * f)}
        if self.proj:
            p["proj"] = kernel(1, c_in, 4 * f)
            p["norm_proj"] = norm(4 * f)
        return p

    def forward(self, p, x):
        y = F.relu(group_norm(conv(x, p["conv1"]["kernel"]), p["norm1"]))
        y = F.relu(group_norm(conv(y, p["conv2"]["kernel"], self.strides),
                              p["norm2"]))
        y = group_norm(conv(y, p["conv3"]["kernel"]), p["norm3"])
        residual = x
        if self.proj:
            residual = group_norm(conv(x, p["proj"]["kernel"], self.strides),
                                  p["norm_proj"])
        return F.relu(residual + y)


class ResNet(nn.Module):
    """The JAX ``ResNet``: ``stage_sizes`` bottleneck blocks per stage
    (``64·2^i`` filters, stride 2 entering every stage after the first,
    a projection on each stage's first block)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int,
                 stem: str = "conv7"):
        super().__init__()
        if stem not in ("conv7", "s2d"):
            raise ValueError(f"unknown stem {stem!r}")
        self.stage_sizes, self.num_classes, self.stem = \
            tuple(stage_sizes), num_classes, stem
        self.blocks = [(f"stage{i}_block{j}",
                        BottleneckBlock(64 * 2 ** i,
                                        2 if i > 0 and j == 0 else 1,
                                        proj=j == 0))
                       for i, n in enumerate(self.stage_sizes)
                       for j in range(n)]

    def init_params(self, seed: int, device) -> Dict:
        """lecun-normal kernels (fan-in ``kh·kw·C_in``), unit norm scales,
        zero biases, drawn on the CPU from a generator seeded with
        ``seed`` and moved to ``device``.  (Not JAX's random bits.)"""
        gen = torch.Generator().manual_seed(int(seed))
        shape = (4, 4, 12, 64) if self.stem == "s2d" else (7, 7, 3, 64)
        params = {"conv_init": {"kernel": lecun_normal(
            shape, shape[0] * shape[1] * shape[2], gen)},
            "norm_init": {"scale": torch.ones(64), "bias": torch.zeros(64)}}
        c = 64
        for name, block in self.blocks:
            params[name] = block.init(c, gen)
            c = 4 * block.filters
        params["head"] = {"kernel": lecun_normal((c, self.num_classes), c,
                                                 gen),
                          "bias": torch.zeros(self.num_classes)}
        return _to_device(params, device)

    def forward(self, params, images: torch.Tensor) -> torch.Tensor:
        """``images`` NHWC → logits ``[B, num_classes]``."""
        if self.stem == "s2d":
            x = space_to_depth(images, 2).permute(0, 3, 1, 2)
            x = conv(x, params["conv_init"]["kernel"],
                     pads=((1, 2), (1, 2)))
        else:
            x = conv(images.permute(0, 3, 1, 2), params["conv_init"]["kernel"],
                     2)
        x = F.relu(group_norm(x, params["norm_init"]))
        x = max_pool_same(x, 3, 2)
        for name, block in self.blocks:
            x = block(params[name], x)
        return dense(x.mean(dim=(2, 3)), params["head"])


def _image_spec(name: str, model: nn.Module, num_classes: int,
                image_size: int) -> ModelSpec:
    """The JAX ``_image_spec``: images NHWC ``[B, S, S, 3]`` standard
    normal, integer labels, mean cross entropy."""
    def init(seed: int = 0, device=None):
        return model.init_params(seed, resolve_device(device))

    def apply_fn(params, images):
        return model(params, torch.as_tensor(images,
                                             device=tree_device(params)))

    def loss_fn(params, batch):
        dev = tree_device(params)
        return cross_entropy_loss(
            model(params, torch.as_tensor(batch["images"], device=dev)),
            torch.as_tensor(batch["labels"], device=dev))

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {
            "images": rng.randn(batch_size, image_size, image_size, 3
                                ).astype(np.float32),
            "labels": rng.randint(0, num_classes, (batch_size,)
                                  ).astype(np.int32),
        }

    return ModelSpec(name=name, init=init, loss_fn=loss_fn, apply_fn=apply_fn,
                     make_batch=make_batch,
                     config=dict(num_classes=num_classes,
                                 image_size=image_size))


def resnet50(num_classes: int = 1000, image_size: int = 224,
             stem: str = "conv7") -> ModelSpec:
    """``stem='s2d'`` uses the space-to-depth stem (the same function as
    the 7x7 conv, see :func:`convert_stem_params`; ``image_size`` must be
    even).  ``spec.init(seed, device=None)`` builds the parameters on
    ``device``, the CUDA card unless the caller asks for another."""
    return _image_spec("resnet50", ResNet([3, 4, 6, 3], num_classes,
                                          stem=stem),
                       num_classes, image_size)


def resnet101(num_classes: int = 1000, image_size: int = 224,
              stem: str = "conv7") -> ModelSpec:
    return _image_spec("resnet101", ResNet([3, 4, 23, 3], num_classes,
                                           stem=stem),
                       num_classes, image_size)
