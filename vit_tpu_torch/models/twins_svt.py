"""Twins-SVT: alternating windowed-local and reduced-global attention (port of
``vit_tpu/models/twins_svt.py``).

Four stages over NHWC maps, each a patch-merging :class:`PatchEmbedding`, a
one-block pre-transformer, a :class:`PEG` and ``depth`` blocks; a block is a
windowed :class:`LocalAttention` and a conv-MLP, then a
:class:`GlobalAttention` (keys and values from a k x k, stride k convolution
of the normalised map) and a conv-MLP.  Stage 4 drops the local pair.  The
head averages the map and projects it.

With ``fused_attention="auto"`` a 16-bit CUDA map runs each residual
attention on the kernels, forward and backward, as ``vit_tpu`` runs its
Pallas kernels:

- :func:`local_attention_residual`: ``x + LocalAttention(ChannelLN(x))``
  through the fused attention block
  (:func:`~vit_tpu_torch.ops.fused_attention_block.fused_attention_block`)
  with the 7 x 7 windows folded into the batch (49 tokens, one short-route
  key tile), the ``ChannelLayerNorm``'s g, b and eps 1e-5, q|k|v from
  ``to_q`` and ``to_kv``.  The short route puts the folded batch on the
  grid's z axis, at most :data:`MAX_WINDOW_GROUPS` groups a launch, so a
  larger fold goes in several launches.
- :func:`global_attention_residual`: ``x + GlobalAttention(ChannelLN(x))``
  through the fused cross-attention block
  (:func:`~vit_tpu_torch.ops.fused_cross_attention.fused_cross_attention`),
  the LayerNorm and the strided k/v convolution outside it, as in
  ``vit_tpu``.  The gates kept are the semantic ones: H and W divisible by
  k (else the SAME-padded convolution gives ceil(H/k) keys and the plain
  modules run), no active dropout, a 16-bit CUDA activation.  ``vit_tpu``'s
  ``n % 8`` and ``n_k <= 512`` gates were a TPU's sublane and VMEM reasons
  and are dropped, so stage 4 (49 tokens, one key) runs on the kernel.
- the conv-MLPs through
  :func:`~vit_tpu_torch.layers.common.fused_conv_mlp_residual`.

A width the kernels do not take raises; nothing falls back to the plain
modules on the card.  The plain attention is ``vit_tpu``'s einsum form:
f32 logits and softmax, the probabilities rounded to the compute dtype for
P·V, an f32 sum rounded once.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
both attentions split by heads (``to_q`` by rows, ``to_kv`` by rows of each
half, ``to_out`` by columns) and the conv-MLPs by hidden units; on the card
the residuals run the split forms of the fused attention block, the fused
cross-attention block and the fused MLP, the plain modules sum each
row-split convolution's partial over the model group.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=`` and ``channels=`` (the image's, which Flax infers at init),
as :class:`vit_tpu_torch.models.scalable_vit.ScalableViT`.
``fused_attention`` and ``fused_mlp`` take ``"auto"`` or ``"never"``.
Images are NHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import (
    COLUMN, KV, PEG, ROW, ChannelLayerNorm, Conv, cast_to, check_fused_mode,
    fused_conv_mlp_residual, glorot_linear_, group_kw, is_split, kernel_activation, linear,
    row_parallel_conv, split_dropout, split_input, windowed_attention_eligible,
)
from vit_tpu_torch.models.scalable_vit import ConvMLP, _unwindows, _windows
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads
from vit_tpu_torch.ops.fused_attention_block import SHORT_MAX_BATCH, fused_attention_block
from vit_tpu_torch.ops.fused_cross_attention import fused_cross_attention

# Window groups one launch of the fused attention block takes (the short
# route's grid.z); a larger fold is cut into launches of at most this many.
MAX_WINDOW_GROUPS = SHORT_MAX_BATCH


def _attention(q, k, v, heads: int, scale: float) -> torch.Tensor:
    """``vit_tpu``'s einsum attention over channel-packed ``(b, n, heads·d)``
    q, k, v: f32 logits, f32 softmax, the probabilities in v's dtype for P·V
    with an f32 sum, rounded once; ``(b, n_q, heads·d_v)`` out."""
    q, k, v = (split_heads(t, heads) for t in (q, k, v))
    attn = torch.softmax((q.float() @ k.float().transpose(-1, -2)) * scale, dim=-1)
    return merge_heads((attn.to(v.dtype).float() @ v.float()).to(v.dtype))


class PatchEmbedding(nn.Module):
    """Space-to-depth in ``(c p1 p2)`` channel order, then a 1x1 ``proj``
    convolution (``vit_tpu/models/twins_svt.py:127-140``)."""

    def __init__(self, dim: int, dim_out: int, patch_size: int, **kw):
        super().__init__()
        self.patch_size = patch_size
        self.proj = Conv(dim * patch_size ** 2, dim_out, 1, **kw)

    def forward(self, fmap: torch.Tensor) -> torch.Tensor:
        b, h, w, c = fmap.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"feature map {h}x{w} is not divisible by the patch size {p}")
        fmap = fmap.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 5, 2, 4)
        return self.proj(fmap.reshape(b, h // p, w // p, c * p * p))


class _Attention(nn.Module):
    """What the two attentions share: ``to_q`` (1x1) and ``to_kv`` (``kv_size``
    square, stride ``kv_size``) convolutions without bias, ``to_out`` a 1x1
    convolution and its dropout.  ``shard`` (a ``ModelShard``, set by
    ``shard_params``) splits it by heads (``tp_cuts``: ``to_q``'s rows, each
    half of ``to_kv``'s, ``to_out``'s columns); the map enters through ``f``
    and ``to_out`` sums its partials over the model group.  ``generator``,
    where given, draws the dropout (``split_dropout``)."""

    shard = None
    tp_cuts = {"to_q.weight": COLUMN, "to_kv.weight": KV, "to_out.0.weight": ROW}

    def __init__(self, dim: int, heads: int, dim_head: int, dropout: float, kv_size: int, **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_q = Conv(dim, inner, 1, use_bias=False, generator=gen, **kw)
        self.to_kv = Conv(dim, 2 * inner, kv_size, kv_size, use_bias=False, generator=gen, **kw)
        self.to_out = nn.Sequential(Conv(inner, dim, 1, generator=gen, **kw), nn.Dropout(dropout))

    @property
    def dropout_active(self) -> bool:
        return self.training and self.to_out[1].p > 0

    def attend(self, q, kv) -> torch.Tensor:
        """Attention of ``(b, n, inner)`` q over ``(b, n_k, 2·inner)`` kv (k
        the first half)."""
        k, v = kv.chunk(2, dim=-1)
        return _attention(q, k, v, self.heads, self.dim_head ** -0.5)

    def project_out(self, out: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
        """``to_out`` over the attention's ``(b, h, w, inner)`` output; row
        split where the attention is."""
        return split_dropout(row_parallel_conv(self.to_out[0], out, self.shard), self.to_out[1],
                             self.shard, generator)


def _check_windows(h: int, w: int, p: int) -> None:
    if h % p or w % p:
        raise ValueError(f"feature map {h}x{w} is not divisible by the local window size {p}")


class LocalAttention(_Attention):
    """Attention within ``patch_size`` x ``patch_size`` windows, folded into
    the batch (``vit_tpu/models/twins_svt.py:158-196``)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 patch_size: int = 7, **kw):
        super().__init__(dim, heads, dim_head, dropout, 1, **kw)
        self.patch_size = patch_size

    def forward(self, fmap: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, h, w, _ = fmap.shape
        p = self.patch_size
        _check_windows(h, w, p)
        fmap = split_input(fmap, self.shard)
        out = self.attend(*(_windows(t, p, p) for t in (self.to_q(fmap), self.to_kv(fmap))))
        return self.project_out(_unwindows(out, b, h, w, p, p), generator)


class GlobalAttention(_Attention):
    """Attention of every token over keys and values from a k x k, stride k
    SAME convolution (``vit_tpu/models/twins_svt.py:199-233``)."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0,
                 k: int = 7, **kw):
        super().__init__(dim, heads, dim_head, dropout, k, **kw)
        self.k = k

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x = split_input(x, self.shard)
        out = self.attend(self.to_q(x).flatten(1, 2), self.to_kv(x).flatten(1, 2))
        return self.project_out(out.reshape(b, h, w, -1), generator)


def local_attention_residual(x: torch.Tensor, norm: ChannelLayerNorm, attn: LocalAttention,
                             mode: str = "auto",
                             generator: torch.Generator | None = None) -> torch.Tensor:
    """``x + attn(norm(x))``: with :func:`windowed_attention_eligible`'s gate,
    through the fused attention block over the windows folded into the batch,
    ``(b x y) (p1 p2) c``, in launches of at most :data:`MAX_WINDOW_GROUPS`
    groups (``vit_tpu``'s ``_fused_local_attention_residual``,
    ``twins_svt.py:69-106``); else the plain modules.  A map the window size
    does not divide raises either way.  A split ``attn`` takes the block's
    split form: ``to_q``'s rows and ``to_kv``'s rows of each half make the
    rank's packed q|k|v rows.  ``generator`` goes to the plain path's
    dropout."""
    b, h, w, c = x.shape
    p = attn.patch_size
    _check_windows(h, w, p)
    if not windowed_attention_eligible(x, attn, mode):
        return x + attn(norm(x), generator)
    out = attn.to_out[0]
    wqkv = torch.cat([cast_to(attn.to_q.weight, x).flatten(1),
                      cast_to(attn.to_kv.weight, x).flatten(1)])
    weights = (wqkv, cast_to(out.weight, x).flatten(1), cast_to(out.bias, x))
    y = torch.cat([fused_attention_block(xw, norm.g, norm.b, *weights, attn.heads,
                                         attn.dim_head, attn.dim_head ** -0.5, norm.eps,
                                         **group_kw(attn))
                   for xw in _windows(x, p, p).split(MAX_WINDOW_GROUPS)])
    return _unwindows(y, b, h, w, p, p)


def global_attention_residual(x: torch.Tensor, norm: ChannelLayerNorm, attn: GlobalAttention,
                              mode: str = "auto",
                              generator: torch.Generator | None = None) -> torch.Tensor:
    """``x + attn(norm(x))``: through the fused cross-attention kernels when
    ``mode`` is ``"auto"``, x is a 16-bit CUDA map, its height and width are
    multiples of k and dropout is inactive (``vit_tpu``'s
    ``_fused_global_attention_residual``, ``twins_svt.py:25-66``); else the
    plain modules.  xn is computed once; the strided k/v convolution runs on
    it outside the kernel.  A split ``attn`` takes the block's split form
    over its heads: ``f`` takes xn in f32 before both ``to_q`` (inside the
    kernel) and ``to_kv``, so that the kernel's f32 partial dxn and the
    convolution's share are summed, and summed over the model group, before
    the one rounding to xn's dtype.  ``generator`` goes to the plain path's
    dropout."""
    b, h, w, c = x.shape
    k = attn.k
    if mode != "auto" or not kernel_activation(x) or h % k or w % k or attn.dropout_active:
        return x + attn(norm(x), generator)
    xn = norm(x)
    xq = xn
    if is_split(attn):
        xq = split_input(xn.float(), attn.shard)  # f32: dxn's shares meet unrounded
        xn = xq.to(x.dtype)
    keys, values = (t.contiguous() for t in attn.to_kv(xn).flatten(1, 2).chunk(2, dim=-1))
    out = attn.to_out[0]
    y = fused_cross_attention(
        x.reshape(b, h * w, c).contiguous(), xq.reshape(b, h * w, c).contiguous(),
        cast_to(attn.to_q.weight, x).flatten(1), keys, values, cast_to(out.weight, x).flatten(1),
        cast_to(out.bias, x), attn.heads, attn.dim_head, attn.dim_head, attn.dim_head ** -0.5,
        **group_kw(attn))
    return y.reshape(b, h, w, c)


class TwinsTransformer(nn.Module):
    """One stack of blocks (``vit_tpu/models/twins_svt.py:236-290``).
    ``layers[i]`` holds ``local_norm``, ``local_attn``, ``ff1_norm``, ``ff1``
    (unless ``has_local`` is False), ``global_norm``, ``global_attn``,
    ``ff2_norm`` and ``ff2`` (``local_norm_{i}`` … in the Flax tree)."""

    def __init__(self, dim: int, depth: int, heads: int = 8, dim_head: int = 64,
                 mlp_mult: int = 4, local_patch_size: int = 7, global_k: int = 7,
                 dropout: float = 0.0, has_local: bool = True, fused_attention: str = "auto",
                 fused_mlp: str = "auto", **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.has_local = has_local

        def block():
            local = {
                "local_norm": ChannelLayerNorm(dim, **kw),
                "local_attn": LocalAttention(dim, heads, dim_head, dropout, local_patch_size,
                                             generator=gen, **kw),
                "ff1_norm": ChannelLayerNorm(dim, **kw),
                "ff1": ConvMLP(dim, mlp_mult, dropout, generator=gen, **kw),
            } if has_local else {}
            return nn.ModuleDict({
                **local,
                "global_norm": ChannelLayerNorm(dim, **kw),
                "global_attn": GlobalAttention(dim, heads, dim_head, dropout, global_k,
                                               generator=gen, **kw),
                "ff2_norm": ChannelLayerNorm(dim, **kw),
                "ff2": ConvMLP(dim, mlp_mult, dropout, generator=gen, **kw),
            })

        self.layers = nn.ModuleList(block() for _ in range(depth))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.layers:
            if self.has_local:
                x = local_attention_residual(x, layer["local_norm"], layer["local_attn"],
                                             self.fused_attention, generator)
                x = fused_conv_mlp_residual(x, layer["ff1_norm"], layer["ff1"], self.fused_mlp,
                                            generator=generator)
            x = global_attention_residual(x, layer["global_norm"], layer["global_attn"],
                                          self.fused_attention, generator)
            x = fused_conv_mlp_residual(x, layer["ff2_norm"], layer["ff2"], self.fused_mlp,
                                        generator=generator)
        return x


STAGES = ("s1", "s2", "s3", "s4")


class TwinsSVT(nn.Module):
    """Constructor parity: ``vit_tpu/models/twins_svt.py:293-356``.  Modules
    ``s{i}_embed``, ``s{i}_pre_transformer``, ``s{i}_peg``,
    ``s{i}_transformer`` and ``head`` carry the Flax names."""

    def __init__(self, num_classes: int, s1_emb_dim: int = 64, s1_patch_size: int = 4,
                 s1_local_patch_size: int = 7, s1_global_k: int = 7, s1_depth: int = 1,
                 s2_emb_dim: int = 128, s2_patch_size: int = 2, s2_local_patch_size: int = 7,
                 s2_global_k: int = 7, s2_depth: int = 1, s3_emb_dim: int = 256,
                 s3_patch_size: int = 2, s3_local_patch_size: int = 7, s3_global_k: int = 7,
                 s3_depth: int = 5, s4_emb_dim: int = 512, s4_patch_size: int = 2,
                 s4_local_patch_size: int = 7, s4_global_k: int = 7, s4_depth: int = 4,
                 peg_kernel_size: int = 3, dropout: float = 0.0, dtype: torch.dtype | None = None,
                 fused_attention: str = "auto", fused_mlp: str = "auto", *,
                 compute_dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None, channels: int = 3):
        super().__init__()
        self.compute_dtype = compute_dtype
        kw = dict(device=resolve_device(device), dtype=dtype, generator=generator)
        stages = ((s1_emb_dim, s1_patch_size, s1_local_patch_size, s1_global_k, s1_depth),
                  (s2_emb_dim, s2_patch_size, s2_local_patch_size, s2_global_k, s2_depth),
                  (s3_emb_dim, s3_patch_size, s3_local_patch_size, s3_global_k, s3_depth),
                  (s4_emb_dim, s4_patch_size, s4_local_patch_size, s4_global_k, s4_depth))
        dim = channels
        for prefix, (emb_dim, patch, window, k, depth) in zip(STAGES, stages):
            stack = dict(local_patch_size=window, global_k=k, dropout=dropout,
                         has_local=prefix != "s4", fused_attention=fused_attention,
                         fused_mlp=fused_mlp, **kw)
            self.add_module(f"{prefix}_embed", PatchEmbedding(dim, emb_dim, patch, **kw))
            self.add_module(f"{prefix}_pre_transformer", TwinsTransformer(emb_dim, 1, **stack))
            self.add_module(f"{prefix}_peg", PEG(emb_dim, peg_kernel_size, **kw))
            self.add_module(f"{prefix}_transformer", TwinsTransformer(emb_dim, depth, **stack))
            dim = emb_dim
        self.head = glorot_linear_(nn.Linear(dim, num_classes, device=kw["device"], dtype=dtype),
                                   generator)

    def forward(self, img: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``, where given, draws every dropout (a split model's
        active dropout needs one: the ranks draw one mask)."""
        x = img.to(self.compute_dtype or self.head.weight.dtype)
        for prefix in STAGES:
            x = getattr(self, f"{prefix}_embed")(x)
            x = getattr(self, f"{prefix}_pre_transformer")(x, generator)
            x = getattr(self, f"{prefix}_peg")(x)
            x = getattr(self, f"{prefix}_transformer")(x, generator)
        return linear(self.head, x.mean(dim=(1, 2)))
