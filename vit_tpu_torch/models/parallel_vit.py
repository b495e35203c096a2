"""Parallel ViT: at each depth, parallel attention branches and then parallel
MLP branches, each with its own LayerNorm, summed before the residual (port
of ``vit_tpu/models/parallel_vit.py``).

``vit_tpu`` runs no Pallas kernel here (each branch's sum is not the block
the kernels compute), so the port runs plain modules: the
:class:`~vit_tpu_torch.layers.common.Attention` (plain below 1024 tokens)
and :class:`~vit_tpu_torch.layers.common.MLP`.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
every branch's attention splits by heads and every branch's MLP by hidden
units, as a ``Transformer``'s do; each branch's row-split output is summed
over the model group and rounded on its own before the branches' sum, the
unsplit model's rounding points.  A split model's dropouts draw from the
forward's ``generator``.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=``, ``compute_dtype=``,
``generator=`` and ``channels=``.  Images are NHWC.  The modules carry the
Flax names at the top: ``patch_embedding``, ``cls_token``, ``pos_embedding``,
``attn_norm_{i}_{j}``, ``attn_{i}_{j}``, ``mlp_norm_{i}_{j}``, ``mlp_{i}_{j}``
(depth i, branch j), ``head_norm`` and ``head``.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import pair, resolve_device
from vit_tpu_torch.layers.common import (
    MLP, Attention, LayerNorm, glorot_linear_, linear, model_shard, split_dropout,
)
from vit_tpu_torch.ops.patchify import patchify


class ViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/parallel_vit.py:22-47``."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int, depth: int,
                 heads: int, mlp_dim: int, pool: str = "cls", num_parallel_branches: int = 2,
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: torch.dtype | None = None, *, compute_dtype: torch.dtype | None = None,
                 channels: int = 3, device=None, generator: torch.Generator | None = None):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        # vit_tpu's two asserts, kept under python -O
        if ih % ph or iw % pw:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in {"cls", "mean"}:
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        self.patch_size, self.pool, self.compute_dtype = (ph, pw), pool, compute_dtype
        self.depth, self.branches = depth, num_parallel_branches
        kw = dict(device=resolve_device(device), dtype=dtype)
        num_patches = (ih // ph) * (iw // pw)

        self.patch_embedding = glorot_linear_(nn.Linear(ph * pw * channels, dim, **kw), generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.emb_dropout = nn.Dropout(emb_dropout)
        for i in range(depth):
            for j in range(num_parallel_branches):
                self.add_module(f"attn_norm_{i}_{j}", LayerNorm(dim, **kw))
                self.add_module(f"attn_{i}_{j}", Attention(dim, heads, dim_head, dropout,
                                                           generator=generator, **kw))
            for j in range(num_parallel_branches):
                self.add_module(f"mlp_norm_{i}_{j}", LayerNorm(dim, **kw))
                self.add_module(f"mlp_{i}_{j}", MLP(dim, mlp_dim, dropout, generator=generator,
                                                    **kw))
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def parallel(self, x: torch.Tensor, kind: str, i: int,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """The sum of depth i's ``kind`` branches (``attn`` or ``mlp``), in
        branch order, plus the residual."""
        total = sum(getattr(self, f"{kind}_{i}_{j}")(getattr(self, f"{kind}_norm_{i}_{j}")(x),
                                                     generator=generator)
                    for j in range(self.branches))
        return total + x

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: every dropout's draws, where given; a split model's
        active dropout raises without one."""
        x = patchify(img.to(self.compute_dtype or self.head.weight.dtype), *self.patch_size)
        x = linear(self.patch_embedding, x)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = split_dropout(x + self.pos_embedding[:, :n + 1].to(x.dtype), self.emb_dropout,
                          model_shard(self), generator)
        for i in range(self.depth):
            x = self.parallel(self.parallel(x, "attn", i, generator), "mlp", i, generator)
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return linear(self.head, self.head_norm(x))
