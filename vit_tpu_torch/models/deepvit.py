"""DeepViT: re-attention ViT (port of ``vit_tpu/models/deepvit.py``).

Re-attention mixes the post-softmax attention matrix across heads with a
learned ``(heads, heads)`` matrix and normalises it over the head axis
(``ReAttention``): q·kᵀ in f32 (:func:`attention_weights`), the head mix and
its LayerNorm (eps 1e-3, exact variance) on that f32 matrix whatever the
compute dtype, as ``vit_tpu`` keeps ``reattn_norm`` in f32, then the matrix
cast to v's dtype times v (:func:`apply_attention`).  The attention needs the
materialised matrix, so it runs plain, as in ``vit_tpu``; the MLP half of
each layer goes through :func:`~vit_tpu_torch.layers.common.fused_mlp_residual`:
with 16-bit CUDA activations and no active dropout, the fused MLP kernels
(rows 1–2), forward and backward.  ``vit_tpu``'s ``n >= 128`` gate on that
kernel was a v5e sublane reason and is dropped (DeepViT@256/32 has 65
tokens).

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
each :class:`ReAttention` splits by heads (``tp_cuts``: ``to_qkv`` by heads
in each of q, k and v, ``reattn_weights``' rows, the heads a rank mixes
from, and ``to_out``'s columns); the mix is summed over the model group, the
head-axis LayerNorm runs on every rank over every head with its γ and β
whole (:func:`~vit_tpu_torch.ops.tensor_parallel.mix_across_heads`), and
each rank takes its heads' columns of the result.  Each MLP splits by hidden
units, rows 1–2's split form on the card.  A split model's dropouts draw
from the forward's ``generator``.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=`` and ``channels=``; ``fused_mlp`` takes ``"auto"`` or
``"never"``.  Images are NHWC.  The modules carry the Flax names:
``patch_embedding``, ``cls_token``, ``pos_embedding``, ``layers.{i}`` (the
Flax tree's top-level ``{attn_norm,attn,mlp_norm,mlp}_{i}``; ``attn`` with
``to_qkv``, ``reattn_weights``, ``reattn_norm`` and ``to_out.0``),
``head_norm`` and ``head``.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import (
    COLUMN, MLP, QKV, ROW, LayerNorm, apply_output, cast_to, check_fused_mode, fused_mlp_residual,
    glorot_linear_, group_kw, is_split, linear, model_shard, output_projection, split_dropout,
    split_input,
)
from vit_tpu_torch.ops.attention import apply_attention, attention_weights
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads
from vit_tpu_torch.ops.patchify import patchify
from vit_tpu_torch.ops.tensor_parallel import mix_across_heads


class ReAttention(nn.Module):
    """``vit_tpu/models/deepvit.py:25-61``.  ``shard`` (set by
    ``shard_params``) splits it by heads (``tp_cuts``; see the module
    docstring); ``generator``, where given, draws the output dropout."""

    shard = None
    tp_cuts = {"to_qkv.weight": QKV, "reattn_weights": COLUMN, "to_out.0.weight": ROW}

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = glorot_linear_(nn.Linear(dim, inner * 3, bias=False, **kw), generator)
        self.reattn_weights = nn.Parameter(torch.empty(heads, heads, **kw))
        with torch.no_grad():
            nn.init.normal_(self.reattn_weights, generator=generator)
        self.reattn_norm = LayerNorm(heads, **kw)
        self.to_out = output_projection(inner, dim, dropout, generator, **kw)

    def norm_heads(self, attn: torch.Tensor) -> torch.Tensor:
        """LayerNorm over the head axis, in f32 (the f32 matrix in, f32 out)."""
        return self.reattn_norm(attn.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        x = split_input(x, self.shard)
        q, k, v = (split_heads(t, self.heads) for t in linear(self.to_qkv, x).chunk(3, dim=-1))
        attn = attention_weights(q, k, scale=self.dim_head ** -0.5)  # f32
        attn = mix_across_heads(attn, cast_to(self.reattn_weights, attn), self.norm_heads,
                                **group_kw(self))
        if is_split(self):  # this rank's heads of the whole mix
            attn = attn.narrow(1, self.shard.rank * self.heads, self.heads)
        out = merge_heads(apply_attention(attn, v))
        return apply_output(self.to_out, out, self.shard, generator)


class DeepViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/deepvit.py:64-93``."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int, dim: int, depth: int,
                 heads: int, mlp_dim: int, pool: str = "cls", dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, dtype: torch.dtype | None = None,
                 fused_mlp: str = "auto", *, compute_dtype: torch.dtype | None = None,
                 channels: int = 3, device=None, generator: torch.Generator | None = None):
        super().__init__()
        # vit_tpu's two asserts, kept under python -O
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in {"cls", "mean"}:
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.patch_size, self.pool, self.compute_dtype = patch_size, pool, compute_dtype
        kw = dict(device=resolve_device(device), dtype=dtype)
        num_patches = (image_size // patch_size) ** 2

        self.patch_embedding = glorot_linear_(
            nn.Linear(patch_size * patch_size * channels, dim, **kw), generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.emb_dropout = nn.Dropout(emb_dropout)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "attn_norm": LayerNorm(dim, **kw),
                "attn": ReAttention(dim, heads, dim_head, dropout, generator=generator, **kw),
                "mlp_norm": LayerNorm(dim, **kw),
                "mlp": MLP(dim, mlp_dim, dropout, generator=generator, **kw),
            })
            for _ in range(depth))
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: every dropout's draws, where given; a split model's
        active dropout raises without one."""
        p = self.patch_size
        x = patchify(img.to(self.compute_dtype or self.head.weight.dtype), p, p)
        x = linear(self.patch_embedding, x)
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = split_dropout(x + self.pos_embedding[:, :n + 1].to(x.dtype), self.emb_dropout,
                          model_shard(self), generator)
        for layer in self.layers:
            x = x + layer["attn"](layer["attn_norm"](x), generator)
            x = fused_mlp_residual(x, layer["mlp_norm"], layer["mlp"], self.fused_mlp, generator)
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return linear(self.head, self.head_norm(x))
