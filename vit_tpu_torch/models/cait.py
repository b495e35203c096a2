"""CaiT: Class-Attention in Image Transformers (port of
``vit_tpu/models/cait.py``).

Two encoders: a transformer over the patch tokens, then one over the cls
token alone whose attention takes ``[cls, patches]`` as its context
(class-attention).  Each layer (:class:`CaiTTransformer`) scales both
residual branches by a learned per-channel LayerScale whose initial value
depends on the layer's depth (:func:`layer_scale_init`), and its attention
mixes the heads before and after the softmax (:class:`TalkingHeadsAttention`,
in f32: logits, scale, pre-mix, softmax, post-mix).  ``vit_tpu`` runs no
Pallas kernel in CaiT (its LayerScale residual is not rows 1–2's function),
so neither does the port: plain modules.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
each :class:`TalkingHeadsAttention` of both stacks splits by heads
(``tp_cuts``: ``to_q``'s rows, ``to_kv``'s rows in each half, ``to_out``'s
columns, ``mix_heads_pre_attn``'s rows and ``mix_heads_post_attn``'s
columns, the heads a rank mixes from and into); the pre-mix is summed over
the model group and the softmax runs on every rank over every head
(:func:`~vit_tpu_torch.ops.tensor_parallel.mix_across_heads`).  Each MLP
splits by hidden units (``layers/common.py``'s ``MLP``).  The LayerScale
parameters, the embeddings and the head stay whole.  A split model's
dropouts draw from the forward's ``generator``, every rank of a model group
one mask.

Layer dropout drops whole layers in training only, as ``vit_tpu`` does, with
its rule that at least one layer of a transformer survives; ``keep[i]``
scales both residual branches of layer i.  Its draws come from the
``generator`` passed to the forward (:func:`layer_drop`); a training forward
with ``layer_dropout > 0`` and no generator raises, as Flax does without a
``'dropout'`` rng.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=``, ``compute_dtype=``,
``generator=`` (the initialisation's) and ``channels=``.  Images are NHWC.
The modules carry the Flax names: ``patch_embedding``, ``pos_embedding``,
``cls_token``, ``patch_transformer`` and ``cls_transformer`` (stacks: their
``{attn_norm,attn,mlp_norm,mlp}_{i}`` under ``layers.{i}``, their
``layerscale_{attn,mlp}_{i}`` parameters as they are), ``head_norm`` and
``head``; each attention's ``to_q``, ``to_kv``, ``mix_heads_pre_attn``,
``mix_heads_post_attn`` and ``to_out.0``.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import (
    COLUMN, KV, MLP, ROW, LayerNorm, apply_output, cast_to, glorot_linear_, group_kw, linear,
    model_shard, output_projection, split_dropout, split_input,
)
from vit_tpu_torch.ops.attention import apply_attention
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads
from vit_tpu_torch.ops.patchify import patchify
from vit_tpu_torch.ops.tensor_parallel import mix_across_heads


def layer_scale_init(depth: int) -> float:
    """The LayerScale's initial value at block ``depth`` (1-based;
    ``vit_tpu/models/cait.py:31-37``)."""
    if depth <= 18:
        return 0.1
    if depth <= 24:
        return 1e-5
    return 1e-6


def layer_drop(generator: torch.Generator, depth: int, p: float):
    """One draw of layer dropout: which of ``depth`` layers drop (each with
    probability ``p``) and the layer that survives if all do, on the
    generator's device; module-level so that tests can inject one draw into
    both packages (``vit_tpu``'s ``jax.random.bernoulli`` and ``randint``)."""
    drop = torch.rand(depth, generator=generator, device=generator.device) < p
    forced = torch.randint(0, depth, (), generator=generator, device=generator.device)
    return drop, forced


class TalkingHeadsAttention(nn.Module):
    """``vit_tpu/models/cait.py:40-81``: with a ``context``, the keys and
    values come from ``[x, context]``.  ``shard`` (set by ``shard_params``)
    splits it by heads (``tp_cuts``; see the module docstring);
    ``generator``, where given, draws the output dropout."""

    shard = None
    tp_cuts = {"to_q.weight": COLUMN, "to_kv.weight": KV, "to_out.0.weight": ROW,
               "mix_heads_pre_attn": COLUMN, "mix_heads_post_attn": ROW}

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = glorot_linear_(nn.Linear(dim, inner, bias=False, **kw), generator)
        self.to_kv = glorot_linear_(nn.Linear(dim, inner * 2, bias=False, **kw), generator)
        self.mix_heads_pre_attn = nn.Parameter(torch.empty(heads, heads, **kw))
        self.mix_heads_post_attn = nn.Parameter(torch.empty(heads, heads, **kw))
        with torch.no_grad():
            nn.init.normal_(self.mix_heads_pre_attn, generator=generator)
            nn.init.normal_(self.mix_heads_post_attn, generator=generator)
        self.to_out = output_projection(inner, dim, dropout, generator, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        x = split_input(x, self.shard)
        ctx = x if context is None else torch.cat([x, split_input(context, self.shard)], dim=1)
        q = split_heads(linear(self.to_q, x), self.heads)
        k, v = (split_heads(t, self.heads) for t in linear(self.to_kv, ctx).chunk(2, dim=-1))
        dots = (q.float() @ k.float().transpose(-1, -2)) * self.dim_head ** -0.5
        attn = mix_across_heads(dots, cast_to(self.mix_heads_pre_attn, dots),
                                lambda t: torch.softmax(t, dim=-1), **group_kw(self))
        attn = torch.einsum("bhij,hg->bgij", attn, cast_to(self.mix_heads_post_attn, attn))
        out = merge_heads(apply_attention(attn, v))
        return apply_output(self.to_out, out, self.shard, generator)


class CaiTTransformer(nn.Module):
    """``vit_tpu/models/cait.py:84-129``: ``layers.{i}`` and the LayerScale
    parameters ``layerscale_{attn,mlp}_{i}`` of shape ``(1, 1, dim)``."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0, layer_dropout: float = 0.0, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.depth, self.layer_dropout = depth, layer_dropout
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "attn_norm": LayerNorm(dim, **kw),
                "attn": TalkingHeadsAttention(dim, heads, dim_head, dropout, generator=generator,
                                              **kw),
                "mlp_norm": LayerNorm(dim, **kw),
                "mlp": MLP(dim, mlp_dim, dropout, generator=generator, **kw),
            })
            for _ in range(depth))
        for i in range(depth):
            for branch in ("attn", "mlp"):
                self.register_parameter(f"layerscale_{branch}_{i}", nn.Parameter(
                    torch.full((1, 1, dim), layer_scale_init(i + 1), **kw)))

    def keep(self, x: torch.Tensor, generator: torch.Generator | None):
        """Each layer's keep factor in ``x``'s dtype, or None when no layer
        drops (eval mode, or a rate of 0)."""
        if not (self.layer_dropout > 0 and self.training):
            return None
        if generator is None:
            raise ValueError("layer_dropout in training draws from an explicit generator: "
                             "pass generator= to the forward")
        drop, forced = layer_drop(generator, self.depth, self.layer_dropout)
        # "make sure at least one layer makes it" (vit_tpu/models/cait.py:106-107)
        rescue = drop.all() & (torch.arange(self.depth, device=drop.device) == forced)
        return (~drop | rescue).to(device=x.device, dtype=x.dtype)

    def branch(self, h: torch.Tensor, name: str, i: int, keep) -> torch.Tensor:
        """Layer i's ``name`` branch scaled by its LayerScale and ``keep[i]``."""
        h = h * cast_to(getattr(self, f"layerscale_{name}_{i}"), h)
        return h if keep is None else keep[i] * h

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        keep = self.keep(x, generator)
        for i, layer in enumerate(self.layers):
            h = layer["attn"](layer["attn_norm"](x), context, generator)
            x = x + self.branch(h, "attn", i, keep)
            x = x + self.branch(layer["mlp"](layer["mlp_norm"](x), generator), "mlp", i, keep)
        return x


class CaiT(nn.Module):
    """Constructor parity: ``vit_tpu/models/cait.py:132-157``."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int, dim: int, depth: int,
                 cls_depth: int, heads: int, mlp_dim: int, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0, layer_dropout: float = 0.0,
                 dtype: torch.dtype | None = None, *, compute_dtype: torch.dtype | None = None,
                 channels: int = 3, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if image_size % patch_size:  # vit_tpu's assert, kept under python -O
            raise ValueError("Image dimensions must be divisible by the patch size.")
        self.patch_size, self.compute_dtype = patch_size, compute_dtype
        kw = dict(device=resolve_device(device), dtype=dtype)
        num_patches = (image_size // patch_size) ** 2

        self.patch_embedding = glorot_linear_(
            nn.Linear(patch_size * patch_size * channels, dim, **kw), generator)
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches, dim, **kw))
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.pos_embedding, generator=generator)
            nn.init.normal_(self.cls_token, generator=generator)
        self.emb_dropout = nn.Dropout(emb_dropout)
        self.patch_transformer = CaiTTransformer(dim, depth, heads, dim_head, mlp_dim, dropout,
                                                 layer_dropout, generator=generator, **kw)
        self.cls_transformer = CaiTTransformer(dim, cls_depth, heads, dim_head, mlp_dim, dropout,
                                               layer_dropout, generator=generator, **kw)
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the layer-dropout draws' (needed in training with
        ``layer_dropout > 0``) and, where given, every dropout's; a split
        model's active dropout raises without one."""
        p = self.patch_size
        x = linear(self.patch_embedding,
                   patchify(img.to(self.compute_dtype or self.head.weight.dtype), p, p))
        b, n, _ = x.shape
        x = split_dropout(x + self.pos_embedding[:, :n].to(x.dtype), self.emb_dropout,
                          model_shard(self), generator)
        x = self.patch_transformer(x, generator=generator)
        cls_tokens = self.cls_token.to(x.dtype).expand(b, -1, -1)
        cls_out = self.cls_transformer(cls_tokens, context=x, generator=generator)
        return linear(self.head, self.head_norm(cls_out[:, 0]))
