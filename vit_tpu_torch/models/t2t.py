"""T2T-ViT — Tokens-to-Token progressive tokenization (port of
``vit_tpu/models/t2t.py``).

Each T2T stage unfolds the token map with :func:`extract_patches` (TF-'SAME'
padding, ``tf.image.extract_patches``' ``(kh, kw, c)`` channel order) and, on
every stage but the last, runs a one-layer, one-head transformer whose width
is the unfolded channel count (``dim_head == dim``, so its attention has no
output projection).  At the default ``t2t_layers`` on 224 px RGB images the
two token transformers are 147 wide over 3136 tokens and 1323 wide over 784;
the last unfold (11907 wide over 196) goes through ``patch_embedding``.

On the card, with 16-bit activations, the token transformers run where
``vit_tpu`` runs its Pallas kernels: their attention (no output projection)
through :func:`~vit_tpu_torch.ops.attention.scaled_dot_product_attention`,
whose flash tier takes the first (3136 tokens; one head of 147, zero-padded
to 192, the ``(192, 192)`` flash instance, forward and backward) and whose
plain path takes the second (784 tokens, below the 1024 gate, as in
``vit_tpu``); their MLP through the fused MLP kernels at 147 and 1323.  A
width the kernels refuse raises; nothing falls back to the plain modules.
The encoder is the port's :class:`~vit_tpu_torch.layers.common.Transformer`
(rows 1-4 at dim 512, 8 heads of 64 at the benchmark's config), or
``transformer=``, any module that maps tokens to tokens.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
the encoder splits as a ``Transformer`` does (rows 1-4's split forms on the
card); the token transformers cannot split (one head without an output
projection, MLPs 147 and 1323 wide) and run whole on every rank, on the
unsplit kernels.  ``forward``'s ``generator`` draws every dropout, which a
split model's active dropout needs.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` and ``generator=``, as
:class:`vit_tpu_torch.models.vit.ViT`; the image is cast to the compute
dtype first (``vit_tpu``'s benchmark feeds images in it).  Images are NHWC.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import (
    LayerNorm, Transformer, glorot_linear_, linear, model_shard, split_dropout,
)
from vit_tpu_torch.ops.patchify import extract_patches


def same_output_size(size: int, stride: int) -> int:
    """TF 'SAME' output length: ceil(size / stride)."""
    return -(-size // stride)


class T2TViT(nn.Module):
    """Constructor parity: reference t2t.py:50-52."""

    def __init__(self, image_size: int, num_classes: int, dim: int, depth: int | None = None,
                 heads: int | None = None, mlp_dim: int | None = None, pool: str = "cls",
                 channels: int = 3, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, transformer: nn.Module | None = None,
                 t2t_layers=((7, 4), (3, 2), (3, 2)), dtype: torch.dtype | None = None,
                 scan_layers: bool = False, *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if pool not in {"cls", "mean"}:
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        if transformer is None and any(v is None for v in (depth, heads, mlp_dim)):
            raise ValueError("depth, heads, and mlp_dim must be supplied")
        if scan_layers:
            raise ValueError(
                "scan_layers=True is a lever on XLA compile time (lax.scan over "
                "stacked layers); PyTorch runs eagerly and has no counterpart")
        self.pool, self.compute_dtype = pool, compute_dtype
        self.t2t_layers = tuple(tuple(layer) for layer in t2t_layers)
        kw = dict(device=resolve_device(device), dtype=dtype)
        layer_dim, size = channels, image_size
        for i, (kernel_size, stride) in enumerate(self.t2t_layers):
            layer_dim *= kernel_size ** 2
            size = same_output_size(size, stride)
            if i < len(self.t2t_layers) - 1:  # the Flax tree's t2t_transformer_{i}
                self.add_module(f"t2t_transformer_{i}", Transformer(
                    layer_dim, 1, 1, layer_dim, layer_dim, dropout=dropout,
                    compute_dtype=compute_dtype, generator=generator, **kw))
        self.patch_embedding = glorot_linear_(nn.Linear(layer_dim, dim, **kw), generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, size * size + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.emb_dropout = nn.Dropout(emb_dropout)
        self.transformer = transformer if transformer is not None else Transformer(
            dim, depth, heads, dim_head, mlp_dim, dropout=dropout, compute_dtype=compute_dtype,
            generator=generator, **kw)
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def tokens(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Image → the T2T stages → patch embedding → +CLS → +pos, in the
        compute dtype (no embedding dropout: the distillable student appends
        its token before it); ``generator`` draws the token transformers'
        dropout."""
        x = img.to(self.compute_dtype or self.patch_embedding.weight.dtype)
        last = len(self.t2t_layers) - 1
        for i, (kernel_size, stride) in enumerate(self.t2t_layers):
            if i:
                h = math.isqrt(x.shape[1])
                x = x.reshape(x.shape[0], h, h, x.shape[-1])
            x = extract_patches(x, kernel_size, stride, padding="SAME")
            x = x.reshape(x.shape[0], -1, x.shape[-1])
            if i < last:
                x = getattr(self, f"t2t_transformer_{i}")(x, generator)
        x = linear(self.patch_embedding, x)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        return x + self.pos_embedding[:, : n + 1].to(x.dtype)

    def pool_head(self, x: torch.Tensor) -> torch.Tensor:
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return linear(self.head, self.head_norm(x))

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the draws of every active dropout (a split model's
        need one: the ranks draw one mask)."""
        x = split_dropout(self.tokens(img, generator), self.emb_dropout, model_shard(self),
                          generator)
        return self.pool_head(self.transformer(x, generator=generator))
