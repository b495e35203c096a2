"""ViT with a PatchMerger: learned queries reduce the tokens mid-stack (port
of ``vit_tpu/models/vit_with_patch_merger.py``).

``PatchMerger`` (a public module on its own, as in ``vit_tpu``) normalises
its input and returns ``softmax(queries · LN(x)ᵀ · dim^-0.5) · LN(x)``: n
tokens in, ``num_tokens_out`` out; the logits and the softmax in f32, the
weights cast to the compute dtype before the f32-accumulated product.  The
ViT has no cls token (its position embedding keeps ``num_patches + 1`` rows
and uses the first n), runs the merger after layer ``patch_merge_layer``
(``depth // 2`` by default) and mean-pools.  Its attention is the plain
:class:`~vit_tpu_torch.layers.common.Attention`, as in ``vit_tpu``; the MLP
half of each layer goes through
:func:`~vit_tpu_torch.layers.common.fused_mlp_residual` (rows 1–2 with 16-bit
CUDA activations and no active dropout: 256 tokens an image before the
merger and 8 after it at 256 px, patch 16).

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
each layer's attention splits by heads and its MLP by hidden units, as a
``Transformer``'s do (rows 1–2's split form on the card); the
``PatchMerger``, on replicated tokens, stays whole.  A split model's
dropouts draw from the forward's ``generator``.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=``, ``compute_dtype=``,
``generator=`` and ``channels=``; ``fused_mlp`` takes ``"auto"`` or
``"never"``.  Images are NHWC.  The modules carry the Flax names:
``patch_embedding``, ``pos_embedding``, ``layers.{i}`` (the top-level
``{attn_norm,attn,mlp_norm,mlp}_{i}``), ``patch_merger`` (``queries``,
``norm``; built only where ``vit_tpu`` calls it, so that both trees hold the
same parameters), ``head_norm`` and ``head``.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import default, pair, resolve_device
from vit_tpu_torch.layers.common import (
    MLP, Attention, LayerNorm, cast_to, check_fused_mode, fused_mlp_residual, glorot_linear_,
    linear, model_shard, split_dropout,
)
from vit_tpu_torch.ops.patchify import patchify


class PatchMerger(nn.Module):
    """``vit_tpu/models/vit_with_patch_merger.py:23-43``."""

    def __init__(self, dim: int, num_tokens_out: int, *, device=None, dtype=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.scale = dim ** -0.5
        self.queries = nn.Parameter(torch.empty(num_tokens_out, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.queries, generator=generator)
        self.norm = LayerNorm(dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(x)
        sim = cast_to(self.queries, x).float() @ (x * self.scale).float().transpose(-1, -2)
        attn = torch.softmax(sim, dim=-1)
        return (attn.to(x.dtype).float() @ x.float()).to(x.dtype)


class ViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/vit_with_patch_merger.py:46-75``."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int, depth: int,
                 heads: int, mlp_dim: int, patch_merge_layer: int | None = None,
                 patch_merge_num_tokens: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, dtype: torch.dtype | None = None,
                 fused_mlp: str = "auto", *, compute_dtype: torch.dtype | None = None,
                 channels: int = 3, device=None, generator: torch.Generator | None = None):
        super().__init__()
        ih, iw = pair(image_size)
        ph, pw = pair(patch_size)
        if ih % ph or iw % pw:  # vit_tpu's assert, kept under python -O
            raise ValueError("Image dimensions must be divisible by the patch size.")
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.patch_size, self.compute_dtype = (ph, pw), compute_dtype
        kw = dict(device=resolve_device(device), dtype=dtype)
        num_patches = (ih // ph) * (iw // pw)

        self.patch_embedding = glorot_linear_(nn.Linear(ph * pw * channels, dim, **kw), generator)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.emb_dropout = nn.Dropout(emb_dropout)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "attn_norm": LayerNorm(dim, **kw),
                "attn": Attention(dim, heads, dim_head, dropout, generator=generator, **kw),
                "mlp_norm": LayerNorm(dim, **kw),
                "mlp": MLP(dim, mlp_dim, dropout, generator=generator, **kw),
            })
            for _ in range(depth))
        self.merge_index = default(patch_merge_layer, depth // 2) - 1
        self.patch_merger = (PatchMerger(dim, patch_merge_num_tokens, generator=generator, **kw)
                             if 0 <= self.merge_index < depth else None)
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: every dropout's draws, where given; a split model's
        active dropout raises without one."""
        x = patchify(img.to(self.compute_dtype or self.head.weight.dtype), *self.patch_size)
        x = linear(self.patch_embedding, x)
        x = split_dropout(x + self.pos_embedding[:, :x.shape[1]].to(x.dtype), self.emb_dropout,
                          model_shard(self), generator)
        for i, layer in enumerate(self.layers):
            x = x + layer["attn"](layer["attn_norm"](x), generator=generator)
            x = fused_mlp_residual(x, layer["mlp_norm"], layer["mlp"], self.fused_mlp, generator)
            if i == self.merge_index:
                x = self.patch_merger(x)
        return linear(self.head, self.head_norm(x.mean(dim=1)))
