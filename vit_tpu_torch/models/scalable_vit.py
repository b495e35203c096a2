"""ScalableViT: Scalable Self-Attention and Interactive Windowed
Self-Attention (port of ``vit_tpu/models/scalable_vit.py``).

Four stages over NHWC maps, each a stack of blocks in the paper's order
SSA → FF → (PEG, after the first block) → IWSA → FF, as ``vit_tpu`` runs them
(SURVEY.md §8.3), and a strided 3x3 convolution between stages.

- SSA is cross-attention: queries from a 1x1 convolution of the normalised
  map, keys and values from kernel = stride = r convolutions of it, with
  their own head widths.  With ``fused_attention="auto"`` a 16-bit CUDA call
  runs ``x + SSA(ChannelLN(x))`` through the fused cross-attention kernels
  (:mod:`vit_tpu_torch.ops.fused_cross_attention`), forward and backward, as
  ``vit_tpu``'s ``_fused_ssa_residual``.  The gates kept are the semantic
  ones: H and W divisible by r, no active dropout, a 16-bit CUDA activation.
  ``vit_tpu``'s ``n % 8`` and ``n_k <= 512`` gates were a TPU's sublane and
  VMEM reasons and are dropped; widths the kernels do not take raise.
- IWSA attends within windows over channel-packed q, k, v (1x1 convolutions),
  plus a 3x3 convolution of v (the local interactive module), through
  :func:`vit_tpu_torch.ops.attention.packed_window_attention`: with
  ``"auto"``, the packed flash kernel for 16-bit CUDA windows of 1024 tokens
  or more (stages 1 and 2 at 256 px), the plain path below.
- The feed-forward blocks are conv-MLPs (two 1x1 convolutions around an
  exact-erf GELU) run by :func:`vit_tpu_torch.layers.common.
  fused_conv_mlp_residual`: the fused MLP kernels on a 16-bit CUDA map.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
SSA and IWSA split by heads, the conv-MLPs by hidden units; on the card
:func:`ssa_residual` runs row 6's split form, IWSA the packed flash op
(row 10) over the rank's heads, the conv-MLPs rows 1-2's split form.
IWSA's ``to_v`` stays whole (its local module reads all of v).  The PEGs,
the downsample convolutions and the norms run whole.  ``forward``'s
``generator`` draws every dropout, which a split model's active dropout
needs.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations') and
``generator=``, as :class:`vit_tpu_torch.models.cvt.CvT`.
``fused_attention`` and ``fused_mlp`` take ``"auto"`` or ``"never"``.
Images are NHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import cast_tuple, default, resolve_device
from vit_tpu_torch.layers.common import (
    COLUMN, ROW, ChannelLayerNorm, Conv, GroupedConv, LayerNorm, cast_to, check_fused_mode,
    fused_conv_mlp_residual, gelu_exact, glorot_linear_, group_kw, is_split, kernel_activation,
    linear, row_parallel_conv, split_dropout, split_input,
)
from vit_tpu_torch.ops import tensor_parallel
from vit_tpu_torch.ops.attention import packed_window_attention, scaled_dot_product_attention
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads
from vit_tpu_torch.ops.fused_cross_attention import fused_cross_attention


class ConvMLP(nn.Module):
    """1x1 conv → GELU → dropout → 1x1 conv → dropout
    (``vit_tpu/models/scalable_vit.py:33-49``).  ``shard`` (set by
    ``shard_params`` in Twins-SVT's stacks) splits it by hidden units
    (``tp_cuts``; a rank's width a multiple of 8, as the fused MLP takes it),
    ``fc2``'s bias added once after the sum over the model group.
    ``generator``, where given, draws the dropout (``split_dropout``)."""

    shard = None
    tp_cuts = {"fc1.weight": COLUMN, "fc1.bias": COLUMN, "fc2.weight": ROW}
    tp_multiple = 8

    def __init__(self, dim: int, expansion_factor: int = 4, dropout: float = 0.0, **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.fc1 = Conv(dim, dim * expansion_factor, 1, generator=gen, **kw)
        self.fc2 = Conv(dim * expansion_factor, dim, 1, generator=gen, **kw)
        self.dropout = nn.Dropout(dropout)

    @property
    def dropout_active(self) -> bool:
        return self.training and self.dropout.p > 0

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = gelu_exact(self.fc1(split_input(x, self.shard)))
        h = split_dropout(h, self.dropout, self.shard, generator, hidden=True)
        return split_dropout(row_parallel_conv(self.fc2, h, self.shard), self.dropout, self.shard,
                             generator)


class ScalableSelfAttention(nn.Module):
    """``vit_tpu/models/scalable_vit.py:52-88``: q from a 1x1 convolution, k
    and v from kernel = stride = ``reduction_factor`` convolutions, none with
    a bias; ``to_out`` a 1x1 convolution and its dropout.  ``shard`` (a
    ``ModelShard``, set by ``shard_params``) splits it by heads
    (``tp_cuts``: ``to_q``'s, ``to_k``'s and ``to_v``'s rows, ``to_out``'s
    columns; ``heads`` the local count): the map enters through ``f`` and
    ``to_out`` sums its partials over the model group.  ``to_k`` is cut
    beyond the rule table, which replicates it in ``vit_tpu``: each head's
    keys are its own rows of it, so the numbers are the same.
    ``generator``, where given, draws the dropout (``split_dropout``)."""

    shard = None
    tp_cuts = {"to_q.weight": COLUMN, "to_k.weight": COLUMN, "to_v.weight": COLUMN,
               "to_out.0.weight": ROW}

    def __init__(self, dim: int, heads: int = 8, dim_key: int = 32, dim_value: int = 32,
                 dropout: float = 0.0, reduction_factor: int = 1, **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.heads, self.dim_key, self.dim_value = heads, dim_key, dim_value
        self.reduction_factor = r = reduction_factor
        self.to_q = Conv(dim, dim_key * heads, 1, use_bias=False, generator=gen, **kw)
        self.to_k = Conv(dim, dim_key * heads, r, r, use_bias=False, generator=gen, **kw)
        self.to_v = Conv(dim, dim_value * heads, r, r, use_bias=False, generator=gen, **kw)
        self.to_out = nn.Sequential(Conv(dim_value * heads, dim, 1, generator=gen, **kw),
                                    nn.Dropout(dropout))

    @property
    def dropout_active(self) -> bool:
        return self.training and self.to_out[1].p > 0

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        x = split_input(x, self.shard)
        q, k, v = (split_heads(t.flatten(1, 2), self.heads)
                   for t in (self.to_q(x), self.to_k(x), self.to_v(x)))
        out = scaled_dot_product_attention(q, k, v, scale=self.dim_key ** -0.5)
        out = row_parallel_conv(self.to_out[0], merge_heads(out).reshape(b, h, w, -1), self.shard)
        return split_dropout(out, self.to_out[1], self.shard, generator)


def _windows(t: torch.Tensor, wh: int, ww: int) -> torch.Tensor:
    """``b (x w1) (y w2) c -> (b x y) (w1 w2) c`` (a view for one window)."""
    b, h, w, c = t.shape
    t = t.reshape(b, h // wh, wh, w // ww, ww, c).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(-1, wh * ww, c)


def _unwindows(t: torch.Tensor, b: int, h: int, w: int, wh: int, ww: int) -> torch.Tensor:
    """The inverse of :func:`_windows`."""
    t = t.reshape(b, h // wh, w // ww, wh, ww, -1).permute(0, 1, 3, 2, 4, 5)
    return t.reshape(b, h, w, -1)


class InteractiveWindowedSelfAttention(nn.Module):
    """``vit_tpu/models/scalable_vit.py:91-146``: 1x1 q, k, v convolutions
    without bias, the 3x3 SAME ``local_interactive_module`` over v, attention
    within ``window_size`` windows (the whole map when ``None``) through
    :func:`packed_window_attention` (``fused``: its ``mode``), the local term
    added, ``to_out`` and its dropout.

    ``shard`` (a ``ModelShard``, set by ``shard_params``) splits it by heads
    (``tp_cuts``; ``heads`` the local count): ``to_q``'s and ``to_k``'s rows,
    ``to_out``'s columns, and the ``local_interactive_module``'s output
    channels (its weight's rows and its bias) with their heads.  The local
    module is a dense 3x3 convolution over the whole v, so ``to_v`` stays
    whole on every rank (the plan lists it under ``replicated``): it reads
    the map before ``f``, and ``f`` follows it on v, so that v's gradient
    (each rank's local-module share and its heads' attention share) is
    summed over the model group once; the attention takes this rank's heads
    of v, contiguous, and the packed flash op (row 10) runs over the local
    heads.  Each output channel of the local module reads all of v, so the
    cut keeps the numbers.  ``vit_tpu``'s rule table instead splits
    ``to_v`` and replicates the local module (GSPMD gathers v); an
    all-gather here would cost two all-reduces of a zero-padded v a layer
    over gloo, which has no CUDA all-gather.  ``generator``, where given,
    draws the dropout (``split_dropout``)."""

    shard = None
    tp_cuts = {"to_q.weight": COLUMN, "to_k.weight": COLUMN,
               "local_interactive_module.weight": COLUMN,
               "local_interactive_module.bias": COLUMN, "to_out.0.weight": ROW}

    def __init__(self, dim: int, window_size: int | None, heads: int = 8, dim_key: int = 32,
                 dim_value: int = 32, dropout: float = 0.0, fused: str = "auto", **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.window_size, self.heads, self.dim_key, self.fused = window_size, heads, dim_key, fused
        self.to_q = Conv(dim, dim_key * heads, 1, use_bias=False, generator=gen, **kw)
        self.to_k = Conv(dim, dim_key * heads, 1, use_bias=False, generator=gen, **kw)
        self.to_v = Conv(dim, dim_value * heads, 1, use_bias=False, generator=gen, **kw)
        self.local_interactive_module = Conv(dim_value * heads, dim_value * heads, 3,
                                             generator=gen, **kw)
        self.to_out = nn.Sequential(Conv(dim_value * heads, dim, 1, generator=gen, **kw),
                                    nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, h, w, _ = x.shape
        wh, ww = default(self.window_size, h), default(self.window_size, w)
        if h % wh or w % ww:
            raise ValueError(f"height ({h}) or width ({w}) of feature map is not divisible by "
                             f"the window size ({wh}, {ww})")
        v = self.to_v(x)
        if is_split(self):
            v = tensor_parallel.copy_to_model_parallel(v, self.shard.group)
        x = split_input(x, self.shard)
        q, k = self.to_q(x), self.to_k(x)
        local = self.local_interactive_module(v)
        if is_split(self):
            width = v.shape[-1] // self.shard.size
            v = v[..., self.shard.rank * width:(self.shard.rank + 1) * width].contiguous()
        out = packed_window_attention(*(_windows(t, wh, ww) for t in (q, k, v)), self.heads,
                                      scale=self.dim_key ** -0.5, mode=self.fused)
        out = row_parallel_conv(self.to_out[0], _unwindows(out, b, h, w, wh, ww) + local,
                                self.shard)
        return split_dropout(out, self.to_out[1], self.shard, generator)


def ssa_residual(x: torch.Tensor, norm: ChannelLayerNorm, attn: ScalableSelfAttention,
                 mode: str = "auto", generator: torch.Generator | None = None) -> torch.Tensor:
    """``x + attn(norm(x))``: through the fused cross-attention kernels when
    ``mode`` is ``"auto"``, x is a 16-bit CUDA map, its height and width are
    multiples of the reduction factor and dropout is inactive
    (``vit_tpu``'s ``_fused_ssa_residual``, ``scalable_vit.py:149-186``);
    else the plain modules (``generator`` to their dropout).  The LayerNorm
    and the strided k/v convolutions stay outside the kernel, as there.  A
    split ``attn`` takes the block's split form (row 6's) over its heads, as
    Twins-SVT's global attention does: ``f`` takes xn in f32 before ``to_q``
    (inside the kernel), ``to_k`` and ``to_v``, so that the kernel's f32
    partial dxn and the convolutions' shares meet, and are summed over the
    model group, before the one rounding to xn's dtype."""
    b, h, w, c = x.shape
    r = attn.reduction_factor
    if mode != "auto" or not kernel_activation(x) or h % r or w % r or attn.dropout_active:
        return x + attn(norm(x), generator)
    xn = norm(x)
    xq = xn
    if is_split(attn):
        xq = split_input(xn.float(), attn.shard)  # f32: dxn's shares meet unrounded
        xn = xq.to(x.dtype)
    k, v = attn.to_k(xn), attn.to_v(xn)
    out = attn.to_out[0]
    y = fused_cross_attention(
        x.reshape(b, h * w, c).contiguous(), xq.reshape(b, h * w, c).contiguous(),
        cast_to(attn.to_q.weight, x).flatten(1), k.reshape(b, -1, k.shape[-1]).contiguous(),
        v.reshape(b, -1, v.shape[-1]).contiguous(), cast_to(out.weight, x).flatten(1),
        cast_to(out.bias, x), attn.heads, attn.dim_key, attn.dim_value, attn.dim_key ** -0.5,
        **group_kw(attn))
    return y.reshape(b, h, w, c)


class ScalableTransformer(nn.Module):
    """One stage (``vit_tpu/models/scalable_vit.py:189-248``, the paper's
    block order).  ``layers[i]`` holds ``ssa_norm``, ``ssa``, ``ff1_norm``,
    ``ff1``, ``iwsa_norm``, ``iwsa``, ``ff2_norm`` and ``ff2``
    (``ssa_norm_{i}`` … in the Flax tree); ``peg`` is the depthwise 3x3
    convolution after the first block, ``norm`` the stage's output norm."""

    def __init__(self, dim: int, depth: int, heads: int = 8, ff_expansion_factor: int = 4,
                 dropout: float = 0.0, ssa_dim_key: int = 32, ssa_dim_value: int = 32,
                 ssa_reduction_factor: int = 1, iwsa_dim_key: int = 32, iwsa_dim_value: int = 32,
                 iwsa_window_size: int | None = None, norm_output: bool = True,
                 fused_attention: str = "auto", fused_mlp: str = "auto", **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "ssa_norm": ChannelLayerNorm(dim, **kw),
                "ssa": ScalableSelfAttention(dim, heads, ssa_dim_key, ssa_dim_value, dropout,
                                             ssa_reduction_factor, generator=gen, **kw),
                "ff1_norm": ChannelLayerNorm(dim, **kw),
                "ff1": ConvMLP(dim, ff_expansion_factor, dropout, generator=gen, **kw),
                "iwsa_norm": ChannelLayerNorm(dim, **kw),
                "iwsa": InteractiveWindowedSelfAttention(
                    dim, iwsa_window_size, heads, iwsa_dim_key, iwsa_dim_value, dropout,
                    fused_attention, generator=gen, **kw),
                "ff2_norm": ChannelLayerNorm(dim, **kw),
                "ff2": ConvMLP(dim, ff_expansion_factor, dropout, generator=gen, **kw),
            })
            for _ in range(depth))
        self.peg = GroupedConv(dim, 3, generator=gen, **kw)
        self.norm = ChannelLayerNorm(dim, **kw) if norm_output else None

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``, where given, draws every dropout."""
        for i, layer in enumerate(self.layers):
            x = ssa_residual(x, layer["ssa_norm"], layer["ssa"], self.fused_attention, generator)
            x = fused_conv_mlp_residual(x, layer["ff1_norm"], layer["ff1"], self.fused_mlp,
                                        generator=generator)
            if i == 0:
                x = self.peg(x) + x
            x = x + layer["iwsa"](layer["iwsa_norm"](x), generator)
            x = fused_conv_mlp_residual(x, layer["ff2_norm"], layer["ff2"], self.fused_mlp,
                                        generator=generator)
        return x if self.norm is None else self.norm(x)


class ScalableViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/scalable_vit.py:251-312``.
    Modules ``to_patches``, ``stage_{i}``, ``downsample_{i}``, ``head_norm``
    and ``head`` carry the Flax names.  The per-stage arguments take a tuple
    or one value for every stage."""

    def __init__(self, num_classes: int, dim: int, depth: tuple, heads, reduction_factor,
                 window_size=None, iwsa_dim_key=32, iwsa_dim_value=32, ssa_dim_key=32,
                 ssa_dim_value=32, ff_expansion_factor: int = 4, channels: int = 3,
                 dropout: float = 0.0, dtype: torch.dtype | None = None,
                 fused_attention: str = "auto", fused_mlp: str = "auto",
                 scan_layers: bool = False, *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if not isinstance(depth, tuple):
            raise ValueError("depth needs to be tuple if integers indicating number of "
                             "transformer blocks at that stage")
        if scan_layers:
            raise ValueError(
                "scan_layers=True is a lever on XLA compile time (lax.scan over "
                "stacked layers); PyTorch runs eagerly and has no counterpart")
        self.compute_dtype = compute_dtype
        kw = dict(device=resolve_device(device), dtype=dtype)
        stages = len(depth)
        dims = tuple((2 ** i) * dim for i in range(stages))
        per_stage = [cast_tuple(a, stages) for a in (
            heads, ssa_dim_key, ssa_dim_value, reduction_factor, iwsa_dim_key, iwsa_dim_value,
            window_size)]
        self.stages = stages
        self.to_patches = Conv(channels, dim, 7, 4, generator=generator, **kw)
        for i, (hd, sk, sv, r, ik, iv, ws) in enumerate(zip(*per_stage)):
            self.add_module(f"stage_{i}", ScalableTransformer(
                dims[i], depth[i], hd, ff_expansion_factor, dropout, sk, sv, r, ik, iv, ws,
                fused_attention=fused_attention, fused_mlp=fused_mlp, generator=generator, **kw))
            if i < stages - 1:
                self.add_module(f"downsample_{i}", Conv(dims[i], dims[i] * 2, 3, 2,
                                                        generator=generator, **kw))
        self.head_norm = LayerNorm(dims[-1], **kw)
        self.head = glorot_linear_(nn.Linear(dims[-1], num_classes, **kw), generator)

    def forward(self, img: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``, where given, draws every dropout (a split model's
        active dropout needs one: the ranks draw one mask)."""
        x = self.to_patches(img.to(self.compute_dtype or self.head.weight.dtype))
        for i in range(self.stages):
            x = getattr(self, f"stage_{i}")(x, generator)
            if i < self.stages - 1:
                x = getattr(self, f"downsample_{i}")(x)
        return linear(self.head, self.head_norm(x.mean(dim=(1, 2))))
