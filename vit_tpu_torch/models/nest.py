"""NesT: nested hierarchical transformer (port of ``vit_tpu/models/nest.py``).

The image becomes a map of ``(p1 p2 c)``-ordered patches through a 1 x 1
``patch_embedding`` convolution.  At each hierarchy the map is folded into
``4^level`` blocks, ``b (b1 h) (b2 w) c -> (b b1 b2) h w c``, a
:class:`NesTTransformer` runs over each block with one learned scalar a token
added over the channels, and the blocks unfold; between hierarchies an
aggregate (a 3 x 3 TF-SAME convolution, a ``ChannelLayerNorm`` and a 3 x 3,
stride-2 TF-SAME max pool) doubles the width and halves the map.  The head
normalises the last map, averages it and projects.

With ``fused_attention="auto"`` a 16-bit CUDA map runs each residual
attention, forward and backward, through the fused attention block
(:func:`nest_attention_residual`,
:func:`~vit_tpu_torch.ops.fused_attention_block.fused_attention_block`) over
the blocks folded into the batch (``h·w`` tokens a group: 196 at 224 px,
patch 4), with the ``ChannelLayerNorm``'s g, b and eps 1e-5, q|k|v from
``to_qkv`` and ``to_out.0``; with ``fused_mlp="auto"`` each MLP runs through
the fused MLP (:func:`~vit_tpu_torch.layers.common.fused_conv_mlp_residual`
over the loose ``mlp_fc1_{i}`` / ``mlp_fc2_{i}`` pair), as ``vit_tpu`` runs
its Pallas kernels.  The gates kept are the semantic ones
(:func:`~vit_tpu_torch.layers.common.windowed_attention_eligible`): no active
dropout, a 16-bit CUDA activation.  A width the kernels do not take raises;
nothing falls back to the plain modules on the card.

The plain attention is ``vit_tpu``'s einsum form: f32 logits scaled after
the product, an f32 softmax, the probabilities rounded to the compute dtype
for P·V with an f32 sum, rounded once.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=`` and ``channels=`` (the image's, which Flax infers at init),
as :class:`vit_tpu_torch.models.regionvit.RegionViT`.  ``fused_attention``
and ``fused_mlp`` take ``"auto"`` or ``"never"``.  Images are NHWC.  The
modules carry the Flax names: ``patch_embedding``, ``transformer_{idx}``
with ``pos_emb``, ``attn_norm_{i}``, ``attn_{i}`` (``to_qkv``,
``to_out.0``), ``mlp_norm_{i}``, ``mlp_fc1_{i}`` and ``mlp_fc2_{i}``, then
``aggregate_conv_{idx}``, ``aggregate_norm_{idx}``, ``head_norm`` and
``head``.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
each :class:`NesTAttention` splits by heads (``to_qkv`` by heads in each of
q, k and v, ``to_out``'s columns), on rows 3–4's split form over the folded
blocks; one whose heads the axis does not divide (NesT@224's hierarchy 1, 3
heads, at tp 2) runs whole on every rank and the plan lists it.  Each
:class:`NesTTransformer`'s loose ``mlp_fc1_{i}`` / ``mlp_fc2_{i}`` pairs
split by hidden units, as MobileViT's blocks, on rows 1–2's split form.  The
dropouts of a split model draw from the forward's ``generator``.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import cast_tuple, resolve_device
from vit_tpu_torch.layers.common import (
    COLUMN, QKV, ROW, ChannelLayerNorm, Conv, cast_to, check_fused_mode, fused_conv_mlp_residual,
    glorot_linear_, group_kw, linear, max_pool_same, row_parallel_conv, split_dropout,
    split_input, windowed_attention_eligible,
)
from vit_tpu_torch.models.scalable_vit import _unwindows, _windows
from vit_tpu_torch.models.twins_svt import _attention
from vit_tpu_torch.ops.fused_attention_block import SHORT_MAX_BATCH, fused_attention_block
from vit_tpu_torch.ops.patchify import patchify

# Blocks one launch of the fused attention block takes (the short route's
# grid.z); a larger fold is cut into launches of at most this many.
MAX_WINDOW_GROUPS = SHORT_MAX_BATCH


class NesTAttention(nn.Module):
    """``vit_tpu/models/nest.py:57-88``: dim_head = dim // heads, ``to_qkv``
    a 1x1 convolution without a bias (q|k|v thirds), ``to_out`` a 1x1
    convolution and its dropout.  ``shard`` (set by ``shard_params``)
    splits it by heads (``tp_cuts``), ``to_out``'s bias added once after the
    sum; ``generator``, where given, draws the dropout."""

    shard = None
    tp_cuts = {"to_qkv.weight": QKV, "to_out.0.weight": ROW}

    def __init__(self, dim: int, heads: int = 8, dropout: float = 0.0, **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.heads, self.dim_head = heads, dim // heads
        inner = heads * self.dim_head
        self.to_qkv = Conv(dim, 3 * inner, 1, use_bias=False, generator=gen, **kw)
        self.to_out = nn.Sequential(Conv(inner, dim, 1, generator=gen, **kw), nn.Dropout(dropout))

    @property
    def dropout_active(self) -> bool:
        return self.training and self.to_out[1].p > 0

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        q, k, v = self.to_qkv(split_input(x, self.shard)).flatten(1, 2).chunk(3, dim=-1)
        out = _attention(q, k, v, self.heads, self.dim_head ** -0.5)
        return split_dropout(row_parallel_conv(self.to_out[0], out.reshape(b, h, w, -1),
                                               self.shard), self.to_out[1], self.shard, generator)


def nest_attention_residual(x: torch.Tensor, norm: ChannelLayerNorm, attn: NesTAttention,
                            mode: str = "auto",
                            generator: torch.Generator | None = None) -> torch.Tensor:
    """``x + attn(norm(x))`` over a ``(blocks, h, w, c)`` map: with
    :func:`windowed_attention_eligible`'s gate, through the fused attention
    block over ``(blocks, h·w, c)`` in launches of at most
    :data:`MAX_WINDOW_GROUPS` blocks (``vit_tpu``'s
    ``_fused_nest_attention_residual``, ``nest.py:26-54``); else the plain
    modules (``generator`` their dropout's draws, where given).  A split
    ``attn`` runs rows 3–4's split form over its model group."""
    if not windowed_attention_eligible(x, attn, mode):
        return x + attn(norm(x), generator)
    b, h, w, c = x.shape
    out = attn.to_out[0]
    weights = (cast_to(attn.to_qkv.weight, x).flatten(1), cast_to(out.weight, x).flatten(1),
               cast_to(out.bias, x))
    ys = [fused_attention_block(xg, norm.g, norm.b, *weights, attn.heads, attn.dim_head,
                                attn.dim_head ** -0.5, norm.eps, **group_kw(attn))
          for xg in x.reshape(b, h * w, c).contiguous().split(MAX_WINDOW_GROUPS)]
    return (ys[0] if len(ys) == 1 else torch.cat(ys)).reshape(b, h, w, c)


class NesTTransformer(nn.Module):
    """``vit_tpu/models/nest.py:91-142``: ``pos_emb``, one scalar a token
    (``seq_len`` of them, drawn normal(1.0)) added over the channels, then
    ``depth`` layers of ``attn_norm_{i}``, ``attn_{i}``, ``mlp_norm_{i}``,
    ``mlp_fc1_{i}`` (c → mlp_mult·c) and ``mlp_fc2_{i}``.  ``shard`` (set by
    ``shard_params``) splits the MLPs by hidden units (``tp_cuts``:
    ``mlp_fc1_{i}``'s rows and bias, ``mlp_fc2_{i}``'s columns), as
    MobileViT's blocks; ``generator``, where given, draws every dropout."""

    shard = None
    tp_multiple = 8

    def __init__(self, dim: int, seq_len: int, depth: int, heads: int, mlp_mult: int,
                 dropout: float = 0.0, fused_attention: str = "auto", fused_mlp: str = "auto",
                 *, device=None, dtype=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.depth = depth
        self.pos_emb = nn.Parameter(torch.empty(seq_len, **kw))
        with torch.no_grad():
            nn.init.normal_(self.pos_emb, std=1.0, generator=generator)
        self.dropout = nn.Dropout(dropout)
        for i in range(depth):
            self.add_module(f"attn_norm_{i}", ChannelLayerNorm(dim, **kw))
            self.add_module(f"attn_{i}", NesTAttention(dim, heads, dropout, generator=generator,
                                                       **kw))
            self.add_module(f"mlp_norm_{i}", ChannelLayerNorm(dim, **kw))
            self.add_module(f"mlp_fc1_{i}", Conv(dim, dim * mlp_mult, 1, generator=generator,
                                                 **kw))
            self.add_module(f"mlp_fc2_{i}", Conv(dim * mlp_mult, dim, 1, generator=generator,
                                                 **kw))

    @property
    def tp_cuts(self) -> dict:
        return {f"mlp_{name}_{i}.{leaf}": kind for i in range(self.depth)
                for name, leaf, kind in (("fc1", "weight", COLUMN), ("fc1", "bias", COLUMN),
                                         ("fc2", "weight", ROW))}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        _, h, w, _ = x.shape
        x = x + self.pos_emb[:h * w].reshape(1, h, w, 1).to(x.dtype)
        for i in range(self.depth):
            x = nest_attention_residual(x, getattr(self, f"attn_norm_{i}"),
                                        getattr(self, f"attn_{i}"), self.fused_attention,
                                        generator)
            x = fused_conv_mlp_residual(x, getattr(self, f"mlp_norm_{i}"), None, self.fused_mlp,
                                        fc1=getattr(self, f"mlp_fc1_{i}"),
                                        fc2=getattr(self, f"mlp_fc2_{i}"), dropout=self.dropout,
                                        generator=generator, shard=self.shard)
        return x


class NesT(nn.Module):
    """Constructor parity: ``vit_tpu/models/nest.py:145-207``."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int, dim: int, heads: int,
                 num_hierarchies: int, block_repeats, mlp_mult: int = 4, dropout: float = 0.0,
                 dtype: torch.dtype | None = None, fused_attention: str = "auto",
                 fused_mlp: str = "auto", *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None, channels: int = 3):
        super().__init__()
        if image_size % patch_size:  # vit_tpu's assert, kept under python -O
            raise ValueError("Image dimensions must be divisible by the patch size.")
        self.compute_dtype = compute_dtype
        self.patch_size, self.num_hierarchies = patch_size, num_hierarchies
        kw = dict(device=resolve_device(device), dtype=dtype)
        gen = dict(kw, generator=generator)
        fmap_size = image_size // patch_size
        seq_len = (fmap_size // 2 ** (num_hierarchies - 1)) ** 2
        mults = [2 ** i for i in range(num_hierarchies)]
        layer_dims = [m * dim for m in mults]
        dim_pairs = list(zip(layer_dims, [*layer_dims[1:], layer_dims[-1]]))
        repeats = cast_tuple(block_repeats, num_hierarchies)
        self.patch_embedding = Conv(patch_size ** 2 * channels, layer_dims[0], 1, **gen)
        for idx, ((dim_in, dim_out), depth) in enumerate(zip(dim_pairs, repeats)):
            self.add_module(f"transformer_{idx}", NesTTransformer(
                dim_in, seq_len, depth, mults[idx] * heads, mlp_mult, dropout, fused_attention,
                fused_mlp, **gen))
            if idx < num_hierarchies - 1:
                self.add_module(f"aggregate_conv_{idx}", Conv(dim_in, dim_out, 3, **gen))
                self.add_module(f"aggregate_norm_{idx}", ChannelLayerNorm(dim_out, **kw))
        self.head_norm = ChannelLayerNorm(layer_dims[-1], **kw)
        self.head = glorot_linear_(nn.Linear(layer_dims[-1], num_classes, **kw), generator)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the draws of every active dropout, where given (a
        split model's raises without one)."""
        x = img.to(self.compute_dtype or self.head.weight.dtype)
        b, hh, ww, _ = x.shape
        p = self.patch_size
        # b (h p1) (w p2) c -> b h w (p1 p2 c)
        x = self.patch_embedding(patchify(x, p, p).reshape(b, hh // p, ww // p, -1))
        for idx in range(self.num_hierarchies):
            b, hh, ww, c = x.shape
            blocks = 2 ** (self.num_hierarchies - 1 - idx)
            h, w = hh // blocks, ww // blocks
            # b (b1 h) (b2 w) c -> (b b1 b2) h w c, and back
            x = _windows(x, h, w).reshape(-1, h, w, c)
            x = getattr(self, f"transformer_{idx}")(x, generator)
            x = _unwindows(x.reshape(-1, h * w, c), b, hh, ww, h, w)
            if idx < self.num_hierarchies - 1:
                x = getattr(self, f"aggregate_conv_{idx}")(x)
                x = max_pool_same(getattr(self, f"aggregate_norm_{idx}")(x))
        return linear(self.head, self.head_norm(x).mean(dim=(1, 2)))
