"""ATS-ViT: the ViT with Adaptive Token Sampling (port of
``vit_tpu/models/ats_vit.py``).

From its second layer on, each attention keeps at most
``max_tokens_per_depth[i]`` of its tokens: the cls row of the attention,
weighted by the value norms and normalised, gives log pseudo-logits; ``k``
Gumbel-max draws pick tokens, which a sort-based dedup turns into ascending
unique ids with zeros (padding) in front (:func:`adaptive_token_sampling`).
The shapes stay static, as in ``vit_tpu``: every layer keeps ``k + 1`` slots
(the cls slot first), a boolean mask carries the padding through the later
layers, and nothing syncs the host (no ``unique``, ``nonzero`` or ``.item()``).

The attention materialises its matrix: f32 logits, scaled, masked with
``MASK_VALUE`` where either token is padding, an f32 softmax (a fully masked
row comes out uniform), then the matrix in v's dtype times v.  It runs plain,
as in ``vit_tpu``.  The MLP half of each layer goes through
:func:`~vit_tpu_torch.layers.common.fused_mlp_residual` with the model's
``fused_mlp``: ``vit_tpu``'s default ``"never"`` runs the plain modules;
``"auto"`` with 16-bit CUDA activations and no active dropout runs the fused
MLP kernels (rows 1–2), forward and backward, at every layer's token count
(257, 129, 65, … at 256 px, patch 16).

Every draw comes from the forward's ``generator``: the Gumbel noise
(:func:`sample_gumbel`, module-level so that tests inject one noise table
into both packages) and, in training, the dropout masks.  Without one, the
sampling draws from a generator seeded 0 on the input's device, so that a
forward stays deterministic (``vit_tpu``'s ``PRNGKey(0)`` rule: the same
contract, not the same values), and an active dropout raises.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
the attentions split by heads (:class:`ATSAttention`), the MLPs by hidden
units (rows 1-2's split form on the card with ``fused_mlp="auto"``).  The
ranks of a model group keep one token set: the sampling's score sum runs
over the group, and every rank draws the same noise from its copy of the
generator.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=`` (the initialisation's) and ``channels=``; ``fused_mlp`` takes
``"auto"`` or ``"never"``.  Images are NHWC.  The modules carry the Flax
names: ``patch_embedding``, ``cls_token``, ``pos_embedding``, ``transformer``
(its ``{attn_norm,attn,mlp_norm,mlp}_{i}`` under ``layers.{i}``; each
``attn`` with ``to_qkv`` and ``to_out.0``), ``head_norm`` and ``head``.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import pair, resolve_device
from vit_tpu_torch.layers.common import (
    MLP, QKV, ROW, LayerNorm, check_fused_mode, dropout, fused_mlp_residual, glorot_linear_,
    is_split, linear, row_parallel_output, split_input,
)
from vit_tpu_torch.ops import tensor_parallel
from vit_tpu_torch.ops.attention import apply_attention, attention_weights
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads
from vit_tpu_torch.ops.patchify import patchify

MASK_VALUE = -torch.finfo(torch.float32).max
HALF_MASK_VALUE = MASK_VALUE / 2


def log(t: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(t + eps)


def sample_gumbel(generator: torch.Generator, shape, eps: float = 1e-6) -> torch.Tensor:
    """Gumbel noise of ``shape`` in f32 on the generator's device, from
    uniform draws in [0, 1)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -log(-log(u, eps), eps)


def adaptive_token_sampling(attn: torch.Tensor, value: torch.Tensor, mask: torch.Tensor,
                            output_num_tokens: int, generator: torch.Generator,
                            eps: float = 1e-6, group=None):
    """Static-shape ATS (``vit_tpu/models/ats_vit.py:47-86``) over the f32
    attention ``attn`` ``(b, h, n, n)``, the values ``(b, h, n, d)`` and the
    token mask ``(b, n)``.  Returns the attention rows of the sampled queries
    ``(b, h, k + 1, n)``, their mask ``(b, k + 1)`` and their ids ``(b, k +
    1)``: slot 0 is the cls row, padding slots have id 0 and mask False.

    ``group`` (a split attention's model group, ``attn`` and ``value``
    holding this rank's heads): the value-weighted cls row, summed over the
    local heads in f32, is summed over the group before the normalisation,
    so every rank holds the same pseudo-logits, makes the same draw from its
    copy of the generator and keeps the same tokens.  Only the argmax reads
    the sum, so it takes no gradient."""
    b, h, n, _ = attn.shape
    cls_attn = attn[..., 0, 1:]  # (b, h, n - 1)
    # The value norms in v's dtype (the compute dtype: bf16 on the card), a
    # rounding point that decides the sampling, as vit_tpu takes them; the
    # weighting then runs in f32.
    value_norms = torch.linalg.vector_norm(value[..., 1:, :], dim=-1)
    cls_attn = torch.einsum("bhn,bhn->bn", cls_attn, value_norms.to(cls_attn.dtype))
    if group is not None:
        cls_attn = tensor_parallel.all_reduce_sum(cls_attn.detach().clone(), group)
    normed = cls_attn / (cls_attn.sum(-1, keepdim=True) + eps)

    pseudo_logits = torch.where(mask[:, 1:], log(normed), HALF_MASK_VALUE)
    pseudo_logits = pseudo_logits[:, None, :] + sample_gumbel(
        generator, (b, output_num_tokens, n - 1)).to(pseudo_logits.device)
    # Gumbel-max (argmax takes the first maximal index, as jnp.argmax does);
    # +1 reserves id 0 for the cls slot and padding.
    sampled = pseudo_logits.argmax(-1) + 1  # (b, k)

    # Static dedup: sort, zero each id equal to its predecessor, sort again
    # so that the zeros lead and the unique ids follow in ascending order.
    s = sampled.sort(-1).values
    dup = torch.cat([torch.zeros_like(s[:, :1], dtype=torch.bool), s[:, 1:] == s[:, :-1]], -1)
    unique_ids = torch.where(dup, 0, s).sort(-1).values

    cls_slot = torch.ones_like(mask[:, :1])
    new_mask = torch.cat([cls_slot, unique_ids != 0], -1)
    ids = torch.cat([torch.zeros_like(unique_ids[:, :1]), unique_ids], -1)  # (b, k + 1)
    new_attn = attn.gather(2, ids[:, None, :, None].expand(b, h, output_num_tokens + 1, n))
    return new_attn, new_mask, ids


class ATSAttention(nn.Module):
    """``vit_tpu/models/ats_vit.py:89-136``: returns the output, the mask and
    the sampled ids (None where the layer keeps its tokens).

    ``shard`` (a ``ModelShard``, set by ``shard_params``) splits it by heads
    as ``Attention`` is split (``tp_cuts``: ``to_qkv`` by heads in each
    third, ``to_out``'s columns; ``heads`` the local count): the input
    enters through ``f``, the sampling's score sum runs over the model group
    (:func:`adaptive_token_sampling`'s ``group``), the gather of the
    attention rows stays local, and ``to_out``'s f32 partial is summed over
    the group, its bias added once."""

    shard = None
    tp_cuts = {"to_qkv.weight": QKV, "to_out.0.weight": ROW}

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 output_num_tokens: int | None = None, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.heads, self.dim_head, self.dropout = heads, dim_head, dropout
        self.output_num_tokens = output_num_tokens
        inner = heads * dim_head
        self.to_qkv = glorot_linear_(nn.Linear(dim, inner * 3, bias=False, **kw), generator)
        self.to_out = nn.Sequential(glorot_linear_(nn.Linear(inner, dim, **kw), generator))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        num_tokens = x.shape[1]
        q, k, v = (split_heads(t, self.heads)
                   for t in linear(self.to_qkv, split_input(x, self.shard)).chunk(3, dim=-1))
        dots_mask = None if mask is None else mask[:, None, :, None] & mask[:, None, None, :]
        attn = attention_weights(q, k, scale=self.dim_head ** -0.5, mask=dots_mask)  # f32

        sampled_token_ids = None
        if self.output_num_tokens is not None and num_tokens - 1 > self.output_num_tokens:
            gen = generator if generator is not None else \
                torch.Generator(device=x.device).manual_seed(0)
            attn, mask, sampled_token_ids = adaptive_token_sampling(
                attn, v, mask, self.output_num_tokens, gen,
                group=self.shard.group if is_split(self) else None)

        out = row_parallel_output(self.to_out[0], merge_heads(apply_attention(attn, v)),
                                  self.shard)
        return dropout(out, self.dropout, self.training, generator), mask, sampled_token_ids


class ATSTransformer(nn.Module):
    """``vit_tpu/models/ats_vit.py:139-187``: ``layers.{i}`` hold
    ``attn_norm``, ``attn``, ``mlp_norm`` and ``mlp``; the mask and the token
    ids are carried through them, x and the ids gathered after each sampling
    layer."""

    def __init__(self, dim: int, depth: int, max_tokens_per_depth, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0, fused_mlp: str = "auto", *, device=None,
                 dtype=None, generator=None):
        super().__init__()
        # vit_tpu's asserts, kept under python -O
        if len(max_tokens_per_depth) != depth:
            raise ValueError("max_tokens_per_depth must be a tuple of length that is equal to "
                             "the depth of the transformer")
        if sorted(max_tokens_per_depth, reverse=True) != list(max_tokens_per_depth):
            raise ValueError("max_tokens_per_depth must be in decreasing order")
        if min(max_tokens_per_depth) <= 0:
            raise ValueError("max_tokens_per_depth must have at least 1 token at any layer")
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "attn_norm": LayerNorm(dim, **kw),
                "attn": ATSAttention(dim, heads, dim_head, dropout, tokens, generator=generator,
                                     **kw),
                "mlp_norm": LayerNorm(dim, **kw),
                "mlp": MLP(dim, mlp_dim, dropout, generator=generator, **kw),
            })
            for tokens in max_tokens_per_depth)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        b, n = x.shape[:2]
        mask = torch.ones(b, n, dtype=torch.bool, device=x.device)
        token_ids = torch.arange(n, device=x.device).expand(b, n)
        for layer in self.layers:
            attn_out, mask, sampled = layer["attn"](layer["attn_norm"](x), mask, generator)
            if sampled is not None:
                x = x.gather(1, sampled[..., None].expand(-1, -1, x.shape[-1]))
                token_ids = token_ids.gather(1, sampled)
            x = fused_mlp_residual(x + attn_out, layer["mlp_norm"], layer["mlp"], self.fused_mlp,
                                   generator)
        return x, token_ids


class ViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/ats_vit.py:190-216``."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int, depth: int,
                 max_tokens_per_depth, heads: int, mlp_dim: int, dim_head: int = 64,
                 dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: torch.dtype | None = None, fused_mlp: str = "never", *,
                 compute_dtype: torch.dtype | None = None, channels: int = 3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        (ih, iw), (ph, pw) = pair(image_size), pair(patch_size)
        if ih % ph or iw % pw:  # vit_tpu's assert, kept under python -O
            raise ValueError("Image dimensions must be divisible by the patch size.")
        self.patch_size, self.compute_dtype = (ph, pw), compute_dtype
        self.emb_dropout = emb_dropout
        kw = dict(device=resolve_device(device), dtype=dtype)
        num_patches = (ih // ph) * (iw // pw)
        self.patch_embedding = glorot_linear_(nn.Linear(ph * pw * channels, dim, **kw), generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.transformer = ATSTransformer(dim, depth, tuple(max_tokens_per_depth), heads,
                                          dim_head, mlp_dim, dropout, fused_mlp,
                                          generator=generator, **kw)
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def forward(self, img: torch.Tensor, return_sampled_token_ids: bool = False,
                generator: torch.Generator | None = None):
        """``generator``: the Gumbel draws and, in training, the dropout's.
        With ``return_sampled_token_ids`` also the ids of the tokens left
        after the last layer, ``(b, max_tokens_per_depth[-1])``, -1 marking
        padding."""
        x = img.to(self.compute_dtype or self.head.weight.dtype)
        x = linear(self.patch_embedding, patchify(x, *self.patch_size))
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = x + self.pos_embedding[:, :n + 1].to(x.dtype)
        x = dropout(x, self.emb_dropout, self.training, generator)
        x, token_ids = self.transformer(x, generator)
        logits = linear(self.head, self.head_norm(x[:, 0]))
        if return_sampled_token_ids:
            return logits, token_ids[:, 1:] - 1  # the cls slot removed; -1 marks padding
        return logits
