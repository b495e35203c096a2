"""MobileViT: MobileNetV2 blocks interleaved with transformer blocks over
unfolded patches (port of ``vit_tpu/models/mobile_vit.py``).

A 3 x 3, stride-2 :class:`ConvNxNBN` stem and four :class:`MV2Block` s
(inverted residuals: a 1 x 1 expansion, a depthwise 3 x 3, a 1 x 1
projection, each followed by BatchNorm, SiLU after the first two) take the
image to a quarter of its side.  Three stages follow, each a stride-2
``MV2Block`` and a :class:`MobileViTBlock`: local convolutions, the map
unfolded into ``ph·pw`` sequences of ``(h / ph)·(w / pw)`` tokens
(``b (h ph) (w pw) d -> b (ph pw) (h w) d``), a pre-norm transformer over
the token axis (4 heads of 8, an MLP of Dense → SiLU → Dense), the exact
fold back, a 1 x 1 convolution, and the concatenation ``[x, input]`` fused
by a last convolution.  A 1 x 1 ``ConvNxNBN``, a global mean and a head
without bias end it.  At 256 px the three transformers see 4 sequences of
256, 64 and 16 tokens an image.

``vit_tpu`` runs no Pallas kernel in this model, so neither does the port:
every layer is a plain module.  The attention keeps ``vit_tpu``'s einsum
numerics: f32 logits and an f32 softmax, the probabilities rounded to v's
dtype for P·V with an f32 sum.  Every BatchNorm is the port's Flax-parity
:class:`BatchNorm` (Flax momentum 0.9, eps 1e-5); the LayerNorms take eps
1e-3 (``vit_tpu/layers/common.py:44``).

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=`` and ``in_channels=`` (the image's, which Flax infers at init:
``channels`` is already MobileViT's list of stage widths).  Images are NHWC.
The modules carry the Flax names: ``conv1``, ``stem_{i}``,
``trunk_conv_{i}``, ``trunk_attn_{i}`` (``conv1`` … ``conv4``,
``attn_norm_{j}``, ``attn_{j}`` with ``to_qkv`` and ``to_out.0``,
``mlp_norm_{j}``, ``mlp_fc1_{j}``, ``mlp_fc2_{j}``), ``to_logits_conv`` and
``head``; a ``ConvNxNBN`` holds ``conv`` and ``bn``, an ``MV2Block`` ``pw``,
``pw_bn``, ``dw``, ``dw_bn``, ``pw_linear`` and ``pw_linear_bn``.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
the attentions split by heads (4, so up to 4 ranks), the MLPs by hidden
units; the convolutions and BatchNorms run whole.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import (
    COLUMN, QKV, ROW, Attention, BatchNorm, Conv, GroupedConv, LayerNorm, glorot_linear_,
    linear, row_parallel_output, split_dropout, split_input,
)
from vit_tpu_torch.ops.attention import apply_attention, attention_weights


def swish(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


class ConvNxNBN(nn.Module):
    """Conv (no bias, TF-SAME) → BatchNorm → SiLU
    (``vit_tpu/models/mobile_vit.py:27-42``).  ``in_channels`` is the
    input's width, which Flax infers."""

    def __init__(self, dim: int, kernel_size: int = 1, stride: int = 1, *, in_channels: int,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.conv = Conv(in_channels, dim, kernel_size, stride, use_bias=False,
                         generator=generator, **kw)
        self.bn = BatchNorm(dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swish(self.bn(self.conv(x)))


class MV2Block(nn.Module):
    """MobileNetV2 inverted residual (``vit_tpu/models/mobile_vit.py:45-80``),
    no bias anywhere; the residual at stride 1 with ``dim_in == dim_out``.
    As in Flax, ``dim_in`` sets the hidden width (``dim_in · expansion``) and
    the residual rule, and the input may be of another width,
    ``in_channels`` (``dim_in`` by default): MobileViT's fourth stem block
    is declared ``(ch[2], ch[3])`` and takes ``ch[3]`` channels."""

    def __init__(self, dim_in: int, dim_out: int, stride: int = 1, expansion: int = 4, *,
                 in_channels: int | None = None, device=None, dtype=None, generator=None):
        super().__init__()
        if stride not in (1, 2):  # vit_tpu's assert, kept under python -O
            raise ValueError(f"stride must be 1 or 2, got {stride}")
        kw = dict(device=resolve_device(device), dtype=dtype)
        gen = dict(generator=generator, **kw)
        in_channels = in_channels or dim_in
        hidden = int(dim_in * expansion)
        self.use_res = stride == 1 and dim_in == dim_out
        self.expand = expansion != 1
        if self.expand:
            self.pw = Conv(in_channels, hidden, 1, use_bias=False, **gen)
            self.pw_bn = BatchNorm(hidden, **kw)
        self.dw = GroupedConv(hidden if self.expand else in_channels, 3, stride, use_bias=False,
                              out_channels=hidden, **gen)
        self.dw_bn = BatchNorm(hidden, **kw)
        self.pw_linear = Conv(hidden, dim_out, 1, use_bias=False, **gen)
        self.pw_linear_bn = BatchNorm(dim_out, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = swish(self.pw_bn(self.pw(x))) if self.expand else x
        out = swish(self.dw_bn(self.dw(out)))
        out = self.pw_linear_bn(self.pw_linear(out))
        return out + x if self.use_res else out


class MobileViTAttention(Attention):
    """Attention over the ``(b, p, n, d)`` token layout
    (``vit_tpu/models/mobile_vit.py:83-111``): ``to_qkv`` without bias,
    ``to_out`` with bias and its dropout, the ``b·p`` sequences as one batch;
    f32 logits and softmax, P·V in v's dtype with an f32 sum.  ``shard``
    (set by ``shard_params``) splits it by heads as ``Attention`` (``tp_cuts``:
    ``to_qkv`` by heads in each of q, k and v, ``to_out`` by columns).
    ``generator``, where given, draws the dropout."""

    tp_cuts = {"to_qkv.weight": QKV, "to_out.0.weight": ROW}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, p, n, _ = x.shape
        x = split_input(x, self.shard)
        q, k, v = (t.reshape(b * p, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in linear(self.to_qkv, x).chunk(3, dim=-1))
        out = apply_attention(attention_weights(q, k, scale=self.dim_head ** -0.5), v)
        out = out.transpose(1, 2).reshape(b, p, n, self.heads * self.dim_head)
        return split_dropout(row_parallel_output(self.to_out[0], out, self.shard), self.to_out[1],
                             self.shard, generator)


def unfold_patches(x: torch.Tensor, ph: int, pw: int) -> torch.Tensor:
    """``b (h ph) (w pw) d -> b (ph pw) (h w) d``."""
    b, h, w, d = x.shape
    x = x.reshape(b, h // ph, ph, w // pw, pw, d).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, ph * pw, (h // ph) * (w // pw), d)


def fold_patches(x: torch.Tensor, h: int, w: int, ph: int, pw: int) -> torch.Tensor:
    """The inverse of :func:`unfold_patches` onto an ``h x w`` map."""
    b, _, _, d = x.shape
    x = x.reshape(b, ph, pw, h // ph, w // pw, d).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, h, w, d)


class MobileViTBlock(nn.Module):
    """``vit_tpu/models/mobile_vit.py:114-161`` (see the module docstring).
    ``in_channels`` is the input's width (``channel`` by default), which
    Flax infers.  ``shard`` (set by ``shard_params``) splits the MLPs by
    hidden units (``tp_cuts``: ``mlp_fc1_{i}``'s rows and bias,
    ``mlp_fc2_{i}``'s columns), ``mlp_fc2_{i}``'s bias added once after the
    sum.  ``generator``, where given, draws every dropout (``MobileViT``
    builds its blocks at rate 0, as ``vit_tpu``'s does)."""

    shard = None

    def __init__(self, dim: int, depth: int, channel: int, kernel_size: int, patch_size,
                 mlp_dim: int, dropout: float = 0.0, *, in_channels: int | None = None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        gen = dict(generator=generator, **kw)
        in_channels = in_channels or channel
        self.depth, self.patch_size = depth, tuple(patch_size)
        self.conv1 = ConvNxNBN(channel, kernel_size, in_channels=in_channels, **gen)
        self.conv2 = ConvNxNBN(dim, 1, in_channels=channel, **gen)
        for i in range(depth):
            self.add_module(f"attn_norm_{i}", LayerNorm(dim, **kw))
            self.add_module(f"attn_{i}", MobileViTAttention(dim, 4, 8, dropout, **gen))
            self.add_module(f"mlp_norm_{i}", LayerNorm(dim, **kw))
            self.add_module(f"mlp_fc1_{i}", glorot_linear_(nn.Linear(dim, mlp_dim, **kw),
                                                           generator))
            self.add_module(f"mlp_fc2_{i}", glorot_linear_(nn.Linear(mlp_dim, dim, **kw),
                                                           generator))
        self.dropout = nn.Dropout(dropout)
        self.conv3 = ConvNxNBN(channel, 1, in_channels=dim, **gen)
        self.conv4 = ConvNxNBN(channel, kernel_size, in_channels=channel + in_channels, **gen)

    @property
    def tp_cuts(self) -> dict:
        return {f"mlp_{name}_{i}.{leaf}": kind for i in range(self.depth)
                for name, leaf, kind in (("fc1", "weight", COLUMN), ("fc1", "bias", COLUMN),
                                         ("fc2", "weight", ROW))}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        ph, pw = self.patch_size
        y = x
        x = self.conv2(self.conv1(x))
        _, h, w, _ = x.shape
        x = unfold_patches(x, ph, pw)
        for i in range(self.depth):
            x = x + getattr(self, f"attn_{i}")(getattr(self, f"attn_norm_{i}")(x), generator)
            hdn = split_input(getattr(self, f"mlp_norm_{i}")(x), self.shard)
            hdn = swish(linear(getattr(self, f"mlp_fc1_{i}"), hdn))
            hdn = split_dropout(hdn, self.dropout, self.shard, generator, hidden=True)
            x = x + split_dropout(row_parallel_output(getattr(self, f"mlp_fc2_{i}"), hdn,
                                                      self.shard), self.dropout, self.shard,
                                  generator)
        x = self.conv3(fold_patches(x, h, w, ph, pw))
        return self.conv4(torch.cat([x, y], dim=-1))


class MobileViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/mobile_vit.py:164-218``."""

    def __init__(self, image_size, dims, channels, num_classes: int, expansion: int = 4,
                 kernel_size: int = 3, patch_size=(2, 2), depths=(2, 4, 3),
                 dtype: torch.dtype | None = None, *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None, in_channels: int = 3):
        super().__init__()
        # vit_tpu's asserts, kept under python -O
        if len(dims) != 3:
            raise ValueError("dims must be a tuple of 3")
        if len(depths) != 3:
            raise ValueError("depths must be a tuple of 3")
        (ih, iw), (ph, pw) = image_size, patch_size
        if ih % ph or iw % pw:
            raise ValueError(f"image size {(ih, iw)} must be divisible by the patch size "
                             f"{(ph, pw)}")
        self.compute_dtype = compute_dtype
        kw = dict(device=resolve_device(device), dtype=dtype, generator=generator)
        ch = list(channels)
        self.conv1 = ConvNxNBN(ch[0], 3, 2, in_channels=in_channels, **kw)
        stem_cfg = [(ch[0], ch[1], 1), (ch[1], ch[2], 2), (ch[2], ch[3], 1), (ch[2], ch[3], 1)]
        width = ch[0]
        for i, (din, dout, stride) in enumerate(stem_cfg):
            self.add_module(f"stem_{i}", MV2Block(din, dout, stride, expansion, in_channels=width,
                                                  **kw))
            width = dout
        trunk_cfg = [(ch[3], ch[4], dims[0], depths[0], ch[5], int(dims[0] * 2)),
                     (ch[5], ch[6], dims[1], depths[1], ch[7], int(dims[1] * 4)),
                     (ch[7], ch[8], dims[2], depths[2], ch[9], int(dims[2] * 4))]
        for i, (din, dout, dim, depth, channel, mlp_dim) in enumerate(trunk_cfg):
            self.add_module(f"trunk_conv_{i}", MV2Block(din, dout, 2, expansion,
                                                        in_channels=width, **kw))
            self.add_module(f"trunk_attn_{i}", MobileViTBlock(
                dim, depth, channel, kernel_size, patch_size, mlp_dim, in_channels=dout, **kw))
            width = channel
        self.to_logits_conv = ConvNxNBN(ch[-1], 1, in_channels=width, **kw)
        self.head = glorot_linear_(nn.Linear(ch[-1], num_classes, bias=False,
                                             device=kw["device"], dtype=dtype), generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x.to(self.compute_dtype or self.head.weight.dtype))
        for i in range(4):
            x = getattr(self, f"stem_{i}")(x)
        for i in range(3):
            x = getattr(self, f"trunk_attn_{i}")(getattr(self, f"trunk_conv_{i}")(x))
        x = self.to_logits_conv(x)
        return linear(self.head, x.mean(dim=(1, 2)))
