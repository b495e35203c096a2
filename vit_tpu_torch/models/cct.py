"""CCT: the Compact Convolutional Transformer (port of ``vit_tpu/models/cct.py``).

A convolutional tokenizer (``n_conv_layers`` times a TF-SAME convolution
without bias, ReLU and a 3 x 3, stride-2 TF-SAME max pool; the last
convolution ``embedding_dim`` wide, the others ``in_planes``), whose sequence
length is computed analytically (:meth:`CCT.sequence_length`); positions
learned, a fixed sine table (a non-persistent buffer, as ``vit_tpu`` holds it
as a constant) or none; a transformer encoder whose stochastic depth grows
linearly over its layers; sequence pooling (an attention over the tokens)
in place of a cls token, or the cls token with ``seq_pool=False``.

Each encoder layer (:class:`CCTEncoderLayer`) replaces its residual stream
with ``norm1`` before the feed-forward, so the feed-forward is not the fused
MLP's function: ``vit_tpu`` runs no Pallas kernel in CCT, and the port runs
plain modules.  The attention materialises its f32 matrix
(:func:`~vit_tpu_torch.ops.attention.attention_weights`), drops from it, and
multiplies it in v's dtype by v.

Every dropout and stochastic-depth mask comes from the forward's
``generator`` (:func:`~vit_tpu_torch.layers.common.dropout_mask`); a training
forward at a rate above 0 without one raises, as Flax does without a
``'dropout'`` rng.  CCT's defaults draw in training: attention dropout 0.1
and stochastic depth 0.1.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations') and
``generator=`` (the initialisation's); ``n_input_channels`` is the image's.
``vit_tpu``'s legacy keywords ``padding``, ``pooling_padding`` and
``mlp_radio`` are accepted with a warning and ignored; any other unknown
keyword raises ``TypeError``.  Images are NHWC.  The modules carry the Flax
names: ``conv_{i}``, ``positional_emb`` or ``class_emb``, ``block_{i}``
(``pre_norm``, ``self_attn`` with ``to_qkv`` and ``proj``, ``norm1``,
``linear1``, ``linear2``), ``norm``, ``attention_pool`` and ``fc``.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import pair, resolve_device
from vit_tpu_torch.layers.common import (
    Conv, DropPath, LayerNorm, dropout, gelu_exact, glorot_linear_, linear, max_pool_same,
)
from vit_tpu_torch.ops.attention import apply_attention, attention_weights
from vit_tpu_torch.ops.flash_attention_packed import merge_heads, split_heads

__all__ = ["CCT", "cct_2", "cct_4", "cct_6", "cct_7", "cct_8", "cct_14", "cct_16"]

_LEGACY_KWARGS = ("padding", "pooling_padding", "mlp_radio")


def sinusoidal_embedding(n_positions: int, dim: int) -> np.ndarray:
    """The sine table ``(1, n_positions, dim)`` (``vit_tpu/models/cct.py:41-50``)."""
    pe = np.array([[p / (10000 ** (2 * (i // 2) / dim)) for i in range(dim)]
                   for p in range(n_positions)], dtype=np.float32)
    pe[:, 0::2] = np.sin(pe[:, 0::2])
    pe[:, 1::2] = np.cos(pe[:, 1::2])
    return pe[None]


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


class CCTAttention(nn.Module):
    """``vit_tpu/models/cct.py:57-85``: ``head_dim = dim // num_heads``,
    dropout on the f32 attention matrix and on the output projection."""

    def __init__(self, dim: int, num_heads: int = 8, attention_dropout: float = 0.1,
                 projection_dropout: float = 0.1, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.num_heads, self.head_dim = num_heads, dim // num_heads
        self.attention_dropout, self.projection_dropout = attention_dropout, projection_dropout
        self.to_qkv = glorot_linear_(nn.Linear(dim, dim * 3, bias=False, **kw), generator)
        self.proj = glorot_linear_(nn.Linear(dim, dim, **kw), generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        q, k, v = (split_heads(t, self.num_heads)
                   for t in linear(self.to_qkv, x).chunk(3, dim=-1))
        attn = attention_weights(q, k, scale=self.head_dim ** -0.5)  # f32
        attn = dropout(attn, self.attention_dropout, self.training, generator)
        out = linear(self.proj, merge_heads(apply_attention(attn, v)))
        return dropout(out, self.projection_dropout, self.training, generator)


class CCTEncoderLayer(nn.Module):
    """``vit_tpu/models/cct.py:88-119``: ``norm1`` replaces the residual
    stream before the feed-forward (exact-erf GELU)."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int = 2048,
                 dropout: float = 0.1, attention_dropout: float = 0.1,
                 drop_path_rate: float = 0.1, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.dropout = dropout
        self.pre_norm = LayerNorm(d_model, **kw)
        self.self_attn = CCTAttention(d_model, nhead, attention_dropout, dropout,
                                      generator=generator, **kw)
        self.drop_path_attn = DropPath(drop_path_rate)
        self.norm1 = LayerNorm(d_model, **kw)
        self.linear1 = glorot_linear_(nn.Linear(d_model, dim_feedforward, **kw), generator)
        self.linear2 = glorot_linear_(nn.Linear(dim_feedforward, d_model, **kw), generator)
        self.drop_path_ff = DropPath(drop_path_rate)

    def forward(self, src: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.self_attn(self.pre_norm(src), generator)
        src = self.norm1(src + self.drop_path_attn(h, generator))
        h = dropout(gelu_exact(linear(self.linear1, src)), self.dropout, self.training, generator)
        h = dropout(linear(self.linear2, h), self.dropout, self.training, generator)
        return src + self.drop_path_ff(h, generator)


class CCT(nn.Module):
    """Constructor parity: ``vit_tpu/models/cct.py:122-148``."""

    def __init__(self, img_size=224, embedding_dim: int = 768, n_input_channels: int = 3,
                 n_conv_layers: int = 1, kernel_size: int = 7, stride: int = 2,
                 pooling_kernel_size: int = 3, pooling_stride: int = 2, num_layers: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0, num_classes: int = 1000,
                 positional_embedding: str = "sine", in_planes: int = 64,
                 dropout_rate: float = 0.0, attention_dropout: float = 0.1,
                 stochastic_depth_rate: float = 0.1, seq_pool: bool = True,
                 dtype: torch.dtype | None = None, *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None, **legacy):
        super().__init__()
        for k in legacy:
            if k not in _LEGACY_KWARGS:
                raise TypeError(f"CCT got an unexpected keyword argument {k!r}")
            if legacy[k] is not None:
                warnings.warn(f"CCT: legacy kwarg {k!r} is accepted for reference "
                              "compatibility but ignored", stacklevel=2)
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.n_conv_layers, self.stride = n_conv_layers, stride
        self.pooling_kernel_size, self.pooling_stride = pooling_kernel_size, pooling_stride
        self.seq_pool, self.dropout_rate = seq_pool, dropout_rate
        self.compute_dtype = compute_dtype
        img_h, img_w = pair(img_size)
        seq_len = self.sequence_length(n_input_channels, img_h, img_w)

        channels = n_input_channels
        for i in range(n_conv_layers):
            out = embedding_dim if i == n_conv_layers - 1 else in_planes
            self.add_module(f"conv_{i}", Conv(channels, out, kernel_size, stride, use_bias=False,
                                              generator=generator, **kw))
            channels = out

        self.pos_mode = (positional_embedding
                         if positional_embedding in ("sine", "learnable", "none") else "sine")
        n_pos = seq_len if seq_pool else seq_len + 1
        self.seq_len = seq_len
        if not seq_pool:
            self.class_emb = nn.Parameter(torch.zeros(1, 1, embedding_dim, **kw))
        if self.pos_mode == "learnable":
            self.positional_emb = nn.Parameter(torch.empty(1, n_pos, embedding_dim, **kw))
            with torch.no_grad():  # 0.2 · N(0, 1) truncated at ±2, vit_tpu's init
                nn.init.trunc_normal_(self.positional_emb, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                self.positional_emb.mul_(0.2)
        elif self.pos_mode == "sine":
            self.register_buffer("positional_emb", torch.from_numpy(
                sinusoidal_embedding(n_pos, embedding_dim)).to(kw["device"]), persistent=False)

        dim_feedforward = int(embedding_dim * mlp_ratio)
        dpr = np.linspace(0.0, stochastic_depth_rate, num_layers)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"block_{i}", CCTEncoderLayer(
                embedding_dim, num_heads, dim_feedforward, dropout_rate, attention_dropout,
                float(dpr[i]), generator=generator, **kw))
        self.norm = LayerNorm(embedding_dim, **kw)
        if seq_pool:
            self.attention_pool = glorot_linear_(nn.Linear(embedding_dim, 1, **kw), generator)
        self.fc = glorot_linear_(nn.Linear(embedding_dim, num_classes, **kw), generator)

    def sequence_length(self, n_channels: int = 3, height: int = 224, width: int = 224) -> int:
        """The tokenizer's output length: TF-SAME convolutions and pools give
        ``ceil(size / stride)`` (``vit_tpu/models/cct.py:158-168``)."""
        h, w = height, width
        for _ in range(self.n_conv_layers):
            h = _ceil_div(_ceil_div(h, self.stride), self.pooling_stride)
            w = _ceil_div(_ceil_div(w, self.stride), self.pooling_stride)
        return h * w

    def tokens(self, img: torch.Tensor) -> torch.Tensor:
        """The convolutional tokenizer: NHWC image → ``(b, h·w, embedding_dim)``."""
        x = img.to(self.compute_dtype or self.fc.weight.dtype)
        for i in range(self.n_conv_layers):
            x = F.relu(getattr(self, f"conv_{i}")(x))
            x = max_pool_same(x, self.pooling_kernel_size, self.pooling_stride)
        return x.flatten(1, 2)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the dropout and stochastic-depth draws (needed only in
        training at a rate above 0)."""
        x = self.tokens(img)
        if not self.seq_pool:
            x = torch.cat([self.class_emb.to(x.dtype).expand(x.shape[0], -1, -1), x], dim=1)
        if self.pos_mode == "none":
            if x.shape[1] < self.seq_len:  # zero-pad a shorter sequence (vit_tpu's rule)
                x = F.pad(x, (0, 0, 0, self.seq_len - x.shape[1]))
        else:
            x = x + self.positional_emb.to(x.dtype)
        x = dropout(x, self.dropout_rate, self.training, generator)
        for i in range(self.num_layers):
            x = getattr(self, f"block_{i}")(x, generator)
        x = self.norm(x)
        if self.seq_pool:
            # Sequence pooling: a softmax over the tokens in the compute dtype
            # (jax.nn.softmax on w), the weighted sum with an f32 accumulation.
            w = torch.softmax(linear(self.attention_pool, x), dim=1)
            x = torch.einsum("bnl,bnd->bld", w.float(), x.float()).to(x.dtype)[:, 0]
        else:
            x = x[:, 0]
        return linear(self.fc, x)


def _cct(num_layers, num_heads, mlp_ratio, embedding_dim, kernel_size=3, stride=None, **kwargs):
    stride = stride if stride is not None else max(1, (kernel_size // 2) - 1)
    return CCT(num_layers=num_layers, num_heads=num_heads, mlp_ratio=mlp_ratio,
               embedding_dim=embedding_dim, kernel_size=kernel_size, stride=stride, **kwargs)


def cct_2(**kw):
    return _cct(num_layers=2, num_heads=2, mlp_ratio=1, embedding_dim=128, **kw)


def cct_4(**kw):
    return _cct(num_layers=4, num_heads=2, mlp_ratio=1, embedding_dim=128, **kw)


def cct_6(**kw):
    return _cct(num_layers=6, num_heads=4, mlp_ratio=2, embedding_dim=256, **kw)


def cct_7(**kw):
    return _cct(num_layers=7, num_heads=4, mlp_ratio=2, embedding_dim=256, **kw)


def cct_8(**kw):
    return _cct(num_layers=8, num_heads=4, mlp_ratio=2, embedding_dim=256, **kw)


def cct_14(**kw):
    return _cct(num_layers=14, num_heads=6, mlp_ratio=3, embedding_dim=384, **kw)


def cct_16(**kw):
    return _cct(num_layers=16, num_heads=6, mlp_ratio=3, embedding_dim=384, **kw)
