"""Neural Collaborative Filtering (NeuMF).

Port of ``autodist_tpu/models/ncf.py`` (the reference's NCF benchmark on
MovieLens): a GMF tower (the product of the ``mf_*`` user and item
embeddings) and an MLP tower (the ``mlp_*`` embeddings concatenated, then
``mlp_{i}`` dense layers with ReLU), concatenated into the one-logit
``prediction`` layer, with binary cross entropy on implicit feedback.  Same
defaults, config keys, parameter tree and ``sparse_vars`` as the JAX
factory: the four tables take sparse gradients (PS candidates).  The
tables are gathered by indexing, as the port's other models gather theirs.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from autodist_tpu_torch.models.base import (ModelSpec, resolve_device,
                                            tree_device)
from autodist_tpu_torch.models.resnet import dense
from autodist_tpu_torch.models.transformer import lecun_normal
from autodist_tpu_torch.models.transformer_lm import _to_device

TABLES = ("mf_user_embedding", "mf_item_embedding", "mlp_user_embedding",
          "mlp_item_embedding")


class NeuMF(nn.Module):
    def __init__(self, num_users: int, num_items: int, mf_dim: int,
                 mlp_dims: Sequence[int]):
        super().__init__()
        self.num_users, self.num_items = num_users, num_items
        self.mf_dim, self.mlp_dims = mf_dim, tuple(mlp_dims)

    def init_params(self, seed: int, device) -> Dict:
        """normal(0.01) tables, lecun-normal kernels, zero biases (the JAX
        model's initializers), drawn on the CPU from a generator seeded with
        ``seed``.  (Not JAX's random bits.)"""
        gen = torch.Generator().manual_seed(int(seed))
        half = self.mlp_dims[0] // 2
        params = {}
        for name, rows, width in zip(
                TABLES, (self.num_users, self.num_items) * 2,
                (self.mf_dim,) * 2 + (half,) * 2):
            params[name] = torch.randn((rows, width), generator=gen) * 0.01
        width = 2 * half
        for i, d in enumerate(self.mlp_dims[1:]):
            params[f"mlp_{i}"] = {"kernel": lecun_normal((width, d), width,
                                                         gen),
                                  "bias": torch.zeros(d)}
            width = d
        width += self.mf_dim
        params["prediction"] = {"kernel": lecun_normal((width, 1), width,
                                                       gen),
                                "bias": torch.zeros(1)}
        return _to_device(params, device)

    def forward(self, params, users: torch.Tensor,
                items: torch.Tensor) -> torch.Tensor:
        """Integer ``users``, ``items`` ``[B]`` → logits ``[B]``."""
        gmf = params["mf_user_embedding"][users] \
            * params["mf_item_embedding"][items]
        x = torch.cat([params["mlp_user_embedding"][users],
                       params["mlp_item_embedding"][items]], dim=-1)
        for i in range(len(self.mlp_dims) - 1):
            x = F.relu(dense(x, params[f"mlp_{i}"]))
        return dense(torch.cat([gmf, x], dim=-1), params["prediction"])[..., 0]


def ncf(num_users: int = 138496, num_items: int = 26752, mf_dim: int = 64,
        mlp_dims: Sequence[int] = (256, 256, 128, 64)) -> ModelSpec:
    """MovieLens-20M-ish sizes, padded to multiples of 128 (the JAX
    factory's defaults)."""
    model = NeuMF(num_users, num_items, mf_dim, mlp_dims)

    def init(seed: int = 0, device=None):
        return model.init_params(seed, resolve_device(device))

    def apply_fn(params, users, items):
        dev = tree_device(params)
        return model(params, torch.as_tensor(users, device=dev).long(),
                     torch.as_tensor(items, device=dev).long())

    def loss_fn(params, batch):
        logits = apply_fn(params, batch["users"], batch["items"])
        labels = torch.as_tensor(batch["labels"],
                                 device=logits.device).to(logits.dtype)
        return torch.mean(logits.clamp_min(0) - logits * labels
                          + torch.log1p(torch.exp(-logits.abs())))

    def make_batch(rng: np.random.RandomState, batch_size: int):
        return {
            "users": rng.randint(0, num_users, (batch_size,)).astype(np.int32),
            "items": rng.randint(0, num_items, (batch_size,)).astype(np.int32),
            "labels": (rng.rand(batch_size) > 0.5).astype(np.float32),
        }

    return ModelSpec(
        name="ncf",
        init=init, loss_fn=loss_fn, apply_fn=apply_fn, make_batch=make_batch,
        sparse_vars=TABLES,
        config=dict(num_users=num_users, num_items=num_items),
    )
