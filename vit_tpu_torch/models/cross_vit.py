"""CrossViT: a small-patch and a large-patch branch that swap information
through their cls tokens (port of ``vit_tpu/models/cross_vit.py``).

Each of ``depth`` rounds runs both branches' encoders (:class:`NormedTransformer`:
pre-norm layers and a trailing LayerNorm), then :class:`CrossTransformer`:
each branch's cls token, projected into the other branch's width where the
widths differ, attends over itself and the other branch's patch tokens
(``kv_include_self``: the context is ``[cls, patches]``, in that order) and
is projected back.  The logits are the sum of both branches' heads.

:class:`CrossAttention` has separate q and kv projections and runs
:func:`~vit_tpu_torch.ops.attention.scaled_dot_product_attention` (plain
below 1024 tokens, as ``vit_tpu``'s: 257 and 17 keys at 256 px with patches
16 and 64).  Each encoder's MLPs go through
:func:`~vit_tpu_torch.layers.common.fused_mlp_residual`: with 16-bit CUDA
activations and no active dropout, the fused MLP kernels (rows 1–2), forward
and backward.  The constructor's dropouts default to 0.1, as ``vit_tpu``'s;
in training an active dropout runs the plain MLP modules.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
each :class:`CrossAttention`, in the encoders and in the cls tokens' cross
attention, splits by heads (``tp_cuts``: ``to_q``'s rows, ``to_kv``'s rows
in each half, ``to_out``'s columns), each encoder MLP by hidden units (rows
1–2's split form on the card); the projections between the branches'
widths, the embedders, the norms and the heads stay whole.  A split model's
dropouts, the embedders' included, draw from the forward's ``generator``.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=``, ``compute_dtype=``,
``generator=`` and ``channels=``.  ``vit_tpu``'s ``CrossViT`` takes no
``fused_mlp``; its ``NormedTransformer`` does, and so does the port's
(``"auto"`` or ``"never"``).  Images are NHWC.  The modules carry the Flax
names, each at its Flax path: ``{sm,lg}_image_embedder`` (``patch_embedding``,
``cls_token``, ``pos_embedding``), ``{sm,lg}_enc_{r}`` (with
``{attn_norm,attn,mlp_norm,mlp}_{i}`` and ``norm``: not a stack that
``layers.{i}`` holds), ``cross_attend_{r}`` (``{sm,lg}_project_{in,out}_{i}``,
``sm_attend_lg_norm_{i}``, ``sm_attend_lg_{i}``, ``lg_attend_sm_norm_{i}``,
``lg_attend_sm_{i}``), ``{sm,lg}_head_norm`` and ``{sm,lg}_head``; each
attention's ``to_q``, ``to_kv`` and ``to_out.0``.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import (
    COLUMN, KV, MLP, ROW, LayerNorm, apply_output, check_fused_mode, fused_mlp_residual,
    glorot_linear_, linear, model_shard, output_projection, split_dropout, split_input,
)
from vit_tpu_torch.ops.attention import scaled_dot_product_attention
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads
from vit_tpu_torch.ops.patchify import patchify


class CrossAttention(nn.Module):
    """``vit_tpu/models/cross_vit.py:26-56``: q from x, k and v from the
    context (x itself by default; ``[x, context]`` with
    ``kv_include_self``).  ``shard`` (set by ``shard_params``) splits it by
    heads (``tp_cuts``); ``generator``, where given, draws the output
    dropout."""

    shard = None
    tp_cuts = {"to_q.weight": COLUMN, "to_kv.weight": KV, "to_out.0.weight": ROW}

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = glorot_linear_(nn.Linear(dim, inner, bias=False, **kw), generator)
        self.to_kv = glorot_linear_(nn.Linear(dim, inner * 2, bias=False, **kw), generator)
        self.to_out = output_projection(inner, dim, dropout, generator, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                kv_include_self: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = split_input(x, self.shard)
        ctx = x if context is None else split_input(context, self.shard)
        if kv_include_self:
            ctx = torch.cat([x, ctx], dim=1)
        q = split_heads(linear(self.to_q, x), self.heads)
        k, v = (split_heads(t, self.heads) for t in linear(self.to_kv, ctx).chunk(2, dim=-1))
        out = merge_heads(scaled_dot_product_attention(q, k, v, scale=self.dim_head ** -0.5))
        return apply_output(self.to_out, out, self.shard, generator)


class NormedTransformer(nn.Module):
    """``vit_tpu/models/cross_vit.py:59-86``: pre-norm layers, then a
    LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, fused_mlp: str = "auto", *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.depth = depth
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        for i in range(depth):
            self.add_module(f"attn_norm_{i}", LayerNorm(dim, **kw))
            self.add_module(f"attn_{i}", CrossAttention(dim, heads, dim_head, dropout,
                                                        generator=generator, **kw))
            self.add_module(f"mlp_norm_{i}", LayerNorm(dim, **kw))
            self.add_module(f"mlp_{i}", MLP(dim, mlp_dim, dropout, generator=generator, **kw))
        self.norm = LayerNorm(dim, **kw)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(x),
                                               generator=generator)
            x = fused_mlp_residual(x, getattr(self, f"mlp_norm_{i}"), getattr(self, f"mlp_{i}"),
                                   self.fused_mlp, generator)
        return self.norm(x)


class CrossTransformer(nn.Module):
    """``vit_tpu/models/cross_vit.py:89-133``."""

    def __init__(self, sm_dim: int, lg_dim: int, depth: int, heads: int, dim_head: int,
                 dropout: float = 0.0, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.depth, self.need_proj = depth, sm_dim != lg_dim
        # (branch, its width, the other branch's): each branch's cls token
        # attends in the other branch's width
        self.branches = (("sm", "lg", sm_dim, lg_dim), ("lg", "sm", lg_dim, sm_dim))
        for i in range(depth):
            for me, other, d_me, d_other in self.branches:
                if self.need_proj:
                    self.add_module(f"{me}_project_in_{i}", glorot_linear_(
                        nn.Linear(d_me, d_other, **kw), generator))
                self.add_module(f"{me}_attend_{other}_norm_{i}", LayerNorm(d_other, **kw))
                self.add_module(f"{me}_attend_{other}_{i}", CrossAttention(
                    d_other, heads, dim_head, dropout, generator=generator, **kw))
                if self.need_proj:
                    self.add_module(f"{me}_project_out_{i}", glorot_linear_(
                        nn.Linear(d_other, d_me, **kw), generator))

    def forward(self, sm_tokens: torch.Tensor, lg_tokens: torch.Tensor,
                generator: torch.Generator | None = None):
        cls = {"sm": sm_tokens[:, :1], "lg": lg_tokens[:, :1]}
        patches = {"sm": sm_tokens[:, 1:], "lg": lg_tokens[:, 1:]}
        for i in range(self.depth):
            for me, other, _, _ in self.branches:
                h = cls[me]
                if self.need_proj:
                    h = linear(getattr(self, f"{me}_project_in_{i}"), h)
                h = getattr(self, f"{me}_attend_{other}_norm_{i}")(h)
                h = getattr(self, f"{me}_attend_{other}_{i}")(h, context=patches[other],
                                                              kv_include_self=True,
                                                              generator=generator)
                if self.need_proj:
                    h = linear(getattr(self, f"{me}_project_out_{i}"), h)
                cls[me] = h + cls[me]
        return (torch.cat([cls["sm"], patches["sm"]], dim=1),
                torch.cat([cls["lg"], patches["lg"]], dim=1))


class ImageEmbedder(nn.Module):
    """``vit_tpu/models/cross_vit.py:136-164``: patches, a Dense, the cls
    token and the position embedding, dropout."""

    def __init__(self, dim: int, image_size: int, patch_size: int, dropout: float = 0.0,
                 channels: int = 3, *, device=None, dtype=None, generator=None):
        super().__init__()
        if image_size % patch_size:  # vit_tpu's assert, kept under python -O
            raise ValueError("Image dimensions must be divisible by the patch size.")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.patch_size = patch_size
        num_patches = (image_size // patch_size) ** 2
        self.patch_embedding = glorot_linear_(
            nn.Linear(patch_size * patch_size * channels, dim, **kw), generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.dropout = nn.Dropout(dropout)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None,
                shard=None) -> torch.Tensor:
        """``generator`` and ``shard`` (the split model's) as
        :func:`~vit_tpu_torch.layers.common.split_dropout` takes them."""
        x = linear(self.patch_embedding, patchify(img, self.patch_size, self.patch_size))
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        return split_dropout(x + self.pos_embedding[:, :n + 1].to(x.dtype), self.dropout, shard,
                             generator)


class CrossViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/cross_vit.py:167-195``."""

    def __init__(self, image_size: int, num_classes: int, sm_dim: int, lg_dim: int,
                 sm_patch_size: int = 12, sm_enc_depth: int = 1, sm_enc_heads: int = 8,
                 sm_enc_mlp_dim: int = 2048, sm_enc_dim_head: int = 64, lg_patch_size: int = 16,
                 lg_enc_depth: int = 4, lg_enc_heads: int = 8, lg_enc_mlp_dim: int = 2048,
                 lg_enc_dim_head: int = 64, cross_attn_depth: int = 2, cross_attn_heads: int = 8,
                 cross_attn_dim_head: int = 64, depth: int = 3, dropout: float = 0.1,
                 emb_dropout: float = 0.1, dtype: torch.dtype | None = None, *,
                 compute_dtype: torch.dtype | None = None, channels: int = 3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype, generator=generator)
        self.depth, self.compute_dtype = depth, compute_dtype
        self.sm_image_embedder = ImageEmbedder(sm_dim, image_size, sm_patch_size, emb_dropout,
                                               channels, **kw)
        self.lg_image_embedder = ImageEmbedder(lg_dim, image_size, lg_patch_size, emb_dropout,
                                               channels, **kw)
        for r in range(depth):
            self.add_module(f"sm_enc_{r}", NormedTransformer(
                sm_dim, sm_enc_depth, sm_enc_heads, sm_enc_dim_head, sm_enc_mlp_dim, dropout,
                **kw))
            self.add_module(f"lg_enc_{r}", NormedTransformer(
                lg_dim, lg_enc_depth, lg_enc_heads, lg_enc_dim_head, lg_enc_mlp_dim, dropout,
                **kw))
            self.add_module(f"cross_attend_{r}", CrossTransformer(
                sm_dim, lg_dim, cross_attn_depth, cross_attn_heads, cross_attn_dim_head, dropout,
                **kw))
        del kw["generator"]
        self.sm_head_norm = LayerNorm(sm_dim, **kw)
        self.sm_head = glorot_linear_(nn.Linear(sm_dim, num_classes, **kw), generator)
        self.lg_head_norm = LayerNorm(lg_dim, **kw)
        self.lg_head = glorot_linear_(nn.Linear(lg_dim, num_classes, **kw), generator)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: every dropout's draws, where given; a split model's
        active dropout raises without one."""
        img = img.to(self.compute_dtype or self.sm_head.weight.dtype)
        shard = model_shard(self)
        sm_tokens = self.sm_image_embedder(img, generator, shard)
        lg_tokens = self.lg_image_embedder(img, generator, shard)
        for r in range(self.depth):
            sm_tokens = getattr(self, f"sm_enc_{r}")(sm_tokens, generator)
            lg_tokens = getattr(self, f"lg_enc_{r}")(lg_tokens, generator)
            sm_tokens, lg_tokens = getattr(self, f"cross_attend_{r}")(sm_tokens, lg_tokens,
                                                                      generator)
        return (linear(self.sm_head, self.sm_head_norm(sm_tokens[:, 0]))
                + linear(self.lg_head, self.lg_head_norm(lg_tokens[:, 0])))
