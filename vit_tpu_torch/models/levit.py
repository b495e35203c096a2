"""LeViT: a conv-stem hybrid with BatchNorm after every projection and a
learned 2-D position bias (port of ``vit_tpu/models/levit.py``).

Four 3 x 3, stride-2 TF-SAME convolutions make the stem (32, 64, 128 and
``dims[0]`` channels: 224 px to a 14 x 14 map).  Each stage is a
:class:`LeViTTransformer` over the NHWC map; after every stage but the last
a "shrink" transformer (one layer, heads x 2, its queries from a stride-2
convolution, ``dim_out`` the next stage's width) takes the map from ``fs``
to ``ceil(fs / 2)``.  The head averages the map and projects it; with
``num_distill_classes`` a second head gives the distillation logits, and the
forward returns ``(out, distill)``.

:class:`LeViTAttention` takes q, k and v from 1 x 1 convolutions without
bias, each followed by a BatchNorm, and adds a learned bias indexed by
``|Δx|·fs + |Δy|`` (one ``nn.Embedding`` row of ``heads`` entries per
offset) to the logits as ``bias / scale``, as ``vit_tpu`` does
(``levit.py:106``).  Its einsum numerics are kept: f32 logits and an f32
softmax (:func:`~vit_tpu_torch.ops.attention.attention_weights`), the
probabilities rounded to v's dtype for P·V with an f32 sum
(:func:`~vit_tpu_torch.ops.attention.apply_attention`).  Then an exact-erf
GELU, ``to_out`` (a 1 x 1 convolution with bias), ``to_out_bn`` (its γ
starts at 0) and dropout.  ``vit_tpu`` runs no Pallas kernel in this model,
so neither does the port: every layer is a plain module.

Every BatchNorm is the port's Flax-parity :class:`BatchNorm` (Flax momentum
0.9, eps 1e-5).  Flax's ``training`` argument is the module's training mode.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=`` and ``channels=`` (the image's, which Flax infers at init).
Images are NHWC.  The modules carry the Flax names: ``conv_embedding_{i}``,
``stage_{i}`` and ``shrink_{i}`` with ``attn_{j}`` (``to_q``, ``to_q_bn``,
``to_k``, ``to_k_bn``, ``to_v``, ``to_v_bn``, ``pos_bias``, ``to_out.0``,
``to_out_bn``) and ``mlp_{j}`` (``fc1``, ``fc2``), ``mlp_head`` and
``distill_head``.  ``to_out`` is a one-convolution ``nn.Sequential``, so
that the converter's ``to_out`` → ``to_out.0`` rule holds here as for every
other attention.
"""

from __future__ import annotations

from math import ceil

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import default, exists, resolve_device
from vit_tpu_torch.layers.common import BatchNorm, Conv, gelu_exact, glorot_linear_, linear
from vit_tpu_torch.ops.attention import apply_attention, attention_weights


def cast_tuple(val, length: int = 3) -> tuple:
    """``vit_tpu/models/levit.py:31``: a tuple right-padded with its last
    element to ``length``, a scalar repeated."""
    val = val if isinstance(val, tuple) else (val,)
    return (*val, *((val[-1],) * max(length - len(val), 0)))


def hard_swish(x: torch.Tensor) -> torch.Tensor:
    """``x · relu6(x + 3) / 6`` (``vit_tpu/models/levit.py:37``)."""
    return F.hardswish(x)


def position_indices(fmap_size: int, downsample: bool) -> np.ndarray:
    """The ``(queries, keys)`` rows of the position-bias table
    (``vit_tpu/models/levit.py:91-99``): ``|Δx|·fs + |Δy|`` between each
    query (every other position of the ``fs x fs`` map when downsampling)
    and each key, row-major."""
    q_range = np.arange(0, fmap_size, 2 if downsample else 1)
    k_range = np.arange(fmap_size)
    q_pos = np.stack(np.meshgrid(q_range, q_range, indexing="ij"), axis=-1).reshape(-1, 2)
    k_pos = np.stack(np.meshgrid(k_range, k_range, indexing="ij"), axis=-1).reshape(-1, 2)
    rel = np.abs(q_pos[:, None] - k_pos[None, :])
    return rel[..., 0] * fmap_size + rel[..., 1]


def _bn(dim: int, zero_gamma: bool = False, **kw) -> BatchNorm:
    """``vit_tpu``'s ``_bn`` / ``_bn_zero_gamma`` (``levit.py:41-50``)."""
    bn = BatchNorm(dim, momentum=0.1, eps=1e-5, **kw)
    if zero_gamma:
        with torch.no_grad():
            bn.weight.zero_()
    return bn


class LeViTAttention(nn.Module):
    """``vit_tpu/models/levit.py:52-117`` (see the module docstring)."""

    def __init__(self, dim: int, fmap_size: int, heads: int = 8, dim_key: int = 32,
                 dim_value: int = 64, dropout: float = 0.0, dim_out: int | None = None,
                 downsample: bool = False, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        gen = dict(generator=generator, **kw)
        inner_key, inner_value = dim_key * heads, dim_value * heads
        dim_out = default(dim_out, dim)
        self.heads, self.scale = heads, dim_key ** -0.5
        self.to_q = Conv(dim, inner_key, 1, 2 if downsample else 1, use_bias=False, **gen)
        self.to_q_bn = _bn(inner_key, **kw)
        self.to_k = Conv(dim, inner_key, 1, use_bias=False, **gen)
        self.to_k_bn = _bn(inner_key, **kw)
        self.to_v = Conv(dim, inner_value, 1, use_bias=False, **gen)
        self.to_v_bn = _bn(inner_value, **kw)
        self.pos_bias = nn.Embedding(fmap_size * fmap_size, heads, **kw)
        with torch.no_grad():  # Flax's Embed: normal over variance 1 / features
            nn.init.normal_(self.pos_bias.weight, std=heads ** -0.5, generator=generator)
        self.register_buffer("pos_indices", torch.from_numpy(
            position_indices(fmap_size, downsample)).to(kw["device"]), persistent=False)
        self.to_out = nn.Sequential(Conv(inner_value, dim_out, 1, **gen))
        self.to_out_bn = _bn(dim_out, zero_gamma=True, **kw)
        self.dropout = nn.Dropout(dropout)

    def _heads(self, t: torch.Tensor) -> torch.Tensor:
        """``b x y (h d) -> b h (x y) d``."""
        b, x, y, c = t.shape
        return t.reshape(b, x * y, self.heads, c // self.heads).transpose(1, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q = self.to_q_bn(self.to_q(x))
        k = self.to_k_bn(self.to_k(x))
        v = self.to_v_bn(self.to_v(x))
        b, qx, qy, _ = q.shape
        bias = self.pos_bias.weight.float()[self.pos_indices].permute(2, 0, 1) / self.scale
        attn = attention_weights(self._heads(q), self._heads(k), scale=self.scale, bias=bias)
        out = apply_attention(attn, self._heads(v))
        out = out.transpose(1, 2).reshape(b, qx, qy, -1)
        out = self.to_out_bn(self.to_out(gelu_exact(out)))
        return self.dropout(out)


class LeViTMLP(nn.Module):
    """1 x 1 conv → hard swish → dropout → 1 x 1 conv → dropout
    (``vit_tpu/models/levit.py:120-135``)."""

    def __init__(self, dim: int, mult: int, dropout: float = 0.0, *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype, generator=generator)
        self.fc1 = Conv(dim, dim * mult, 1, **kw)
        self.fc2 = Conv(dim * mult, dim, 1, **kw)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(hard_swish(self.fc1(x)))
        return self.dropout(self.fc2(x))


class LeViTTransformer(nn.Module):
    """``vit_tpu/models/levit.py:138-168``: ``depth`` layers ``attn_{i}`` and
    ``mlp_{i}``; the attention's residual only where the layer neither
    downsamples nor changes the width."""

    def __init__(self, dim: int, fmap_size: int, depth: int, heads: int, dim_key: int,
                 dim_value: int, mlp_mult: int = 2, dropout: float = 0.0,
                 dim_out: int | None = None, downsample: bool = False, **kw):
        super().__init__()
        dim_out = default(dim_out, dim)
        self.depth = depth
        self.attn_residual = not downsample and dim == dim_out
        for i in range(depth):
            self.add_module(f"attn_{i}", LeViTAttention(
                dim, fmap_size, heads, dim_key, dim_value, dropout, dim_out, downsample, **kw))
            self.add_module(f"mlp_{i}", LeViTMLP(dim_out, mlp_mult, dropout, **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            out = getattr(self, f"attn_{i}")(x)
            x = out + x if self.attn_residual else out
            x = getattr(self, f"mlp_{i}")(x) + x
        return x


class LeViT(nn.Module):
    """Constructor parity: ``vit_tpu/models/levit.py:171-229``."""

    def __init__(self, image_size: int, num_classes: int, dim, depth, heads, mlp_mult: int,
                 stages: int = 3, dim_key: int = 32, dim_value: int = 64, dropout: float = 0.0,
                 num_distill_classes: int | None = None, dtype: torch.dtype | None = None, *,
                 compute_dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None, channels: int = 3):
        super().__init__()
        dims, depths, layer_heads = (cast_tuple(t, stages) for t in (dim, depth, heads))
        # vit_tpu's assert, kept under python -O
        if not all(len(t) == stages for t in (dims, depths, layer_heads)):
            raise ValueError("dimensions, depths, and heads must be a tuple that is less than "
                             "the designated number of stages")
        self.compute_dtype, self.stages = compute_dtype, stages
        kw = dict(device=resolve_device(device), dtype=dtype)
        gen = dict(generator=generator, **kw)
        c_in = channels
        for i, features in enumerate((32, 64, 128, dims[0])):
            self.add_module(f"conv_embedding_{i}", Conv(c_in, features, 3, 2, **gen))
            c_in = features
        fmap_size = image_size // 2 ** 4
        for ind, (d, dep, hs) in enumerate(zip(dims, depths, layer_heads)):
            self.add_module(f"stage_{ind}", LeViTTransformer(
                d, fmap_size, dep, hs, dim_key, dim_value, mlp_mult, dropout, **gen))
            if ind < stages - 1:
                self.add_module(f"shrink_{ind}", LeViTTransformer(
                    d, fmap_size, 1, hs * 2, dim_key, dim_value, dropout=dropout,
                    dim_out=dims[ind + 1], downsample=True, **gen))
                fmap_size = ceil(fmap_size / 2)
        self.mlp_head = glorot_linear_(nn.Linear(dims[-1], num_classes, **kw), generator)
        self.distill_head = (glorot_linear_(nn.Linear(dims[-1], num_distill_classes, **kw),
                                            generator)
                             if exists(num_distill_classes) else None)

    def forward(self, img: torch.Tensor):
        x = img.to(self.compute_dtype or self.mlp_head.weight.dtype)
        for i in range(4):
            x = getattr(self, f"conv_embedding_{i}")(x)
        for ind in range(self.stages):
            x = getattr(self, f"stage_{ind}")(x)
            if ind < self.stages - 1:
                x = getattr(self, f"shrink_{ind}")(x)
        x = x.mean(dim=(1, 2))
        out = linear(self.mlp_head, x)
        if self.distill_head is not None:
            return out, linear(self.distill_head, x)
        return out
