"""CvT — Convolutional vision Transformer (port of ``vit_tpu/models/cvt.py``).

Three stages, each a strided convolutional token embedding, a channel
LayerNorm and a pre-norm transformer over the NHWC map.  Attention's q, k and
v come from depthwise + BatchNorm + pointwise projections, k and v with a
stride (``kv_proj_stride``), so stage 1 at 224 px attends 3136 queries to 784
keys.  Attention runs through
:func:`vit_tpu_torch.ops.attention.scaled_dot_product_attention`, whose flash
tier takes a 16-bit CUDA call at ``max(n_q, n_k) >= 1024``: CvT-13's stage 1
at 224 px, stages 1 and 2 at 384.  The MLP is two 1x1 convolutions (GEMMs)
around an exact-erf GELU.

Constructor: ``vit_tpu``'s (``num_classes`` and the ``s{1,2,3}_*`` fields,
``dropout``), plus PyTorch's ``device=`` / ``dtype=``, ``compute_dtype=``, a
``generator=`` for the initialisation and ``channels=``, as
:class:`vit_tpu_torch.models.vit.ViT`, and ``use_flash`` (``"auto"`` |
``"never"`` | ``"force"``), the attention op's own argument in ``vit_tpu``.
Flax's ``training`` argument is the module's training mode: BatchNorm uses
batch statistics and updates its running ones there.  Images are NHWC.

Tensor parallelism (:func:`vit_tpu_torch.parallel.sharding.shard_params`):
each attention whose heads the axis divides splits by heads, the flash
dispatch taking the local head count; the others (CvT-13's stages 1-2 at
tp 2) run whole on every rank.  The MLPs split by hidden units.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import (
    COLUMN, KV, ROW, BatchNorm, ChannelLayerNorm, Conv, GroupedConv, gelu_exact,
    glorot_linear_, linear, row_parallel_conv, split_dropout, split_input,
)
from vit_tpu_torch.ops.attention import USE_FLASH_MODES, scaled_dot_product_attention

STAGE_FIELDS = ("emb_dim", "emb_kernel", "emb_stride", "proj_kernel", "kv_proj_stride", "heads",
                "depth", "mlp_mult")


class CvTDepthWiseConv2d(nn.Module):
    """Depthwise conv → BatchNorm(momentum 0.9 in Flax, eps 1e-5) →
    pointwise 1x1 conv (``vit_tpu/models/cvt.py:26-46``).  Given its split
    attention's ``shard``, the pointwise half holds the rank's rows; the
    depthwise convolution and its BatchNorm run whole, and ``f`` sits
    between that BatchNorm and the pointwise half."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, stride: int,
                 use_bias: bool = True, **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.depthwise = GroupedConv(dim_in, kernel_size, stride, use_bias, generator=gen, **kw)
        self.bn = BatchNorm(dim_in, **kw)
        self.pointwise = Conv(dim_in, dim_out, 1, use_bias=use_bias, generator=gen, **kw)

    def forward(self, x: torch.Tensor, shard=None) -> torch.Tensor:
        return self.pointwise(split_input(self.bn(self.depthwise(x)), shard))


def _fold_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``b x y (h d) -> b h (x y) d``, a view (h outer in the channels)."""
    b, x, y, c = t.shape
    return t.reshape(b, x * y, heads, c // heads).permute(0, 2, 1, 3)


class CvTAttention(nn.Module):
    """``vit_tpu/models/cvt.py:49-88``: q from a stride-1 projection, k and v
    the two halves of one strided ``to_kv`` projection; heads folded as
    ``b x y (h d) -> b h (x y) d``, views of the channels-last maps that the
    flash kernel reads through their strides; ``to_out`` a 1x1 conv and its
    dropout.  ``shard`` (set by ``shard_params``) splits it by heads
    (``tp_cuts``: the pointwise halves of ``to_q`` by rows and ``to_kv`` by
    rows of each half, ``to_out`` by columns), ``to_out``'s bias added once
    after the sum.  ``generator``, where given, draws the dropout."""

    shard = None
    tp_cuts = {"to_q.pointwise.weight": COLUMN, "to_kv.pointwise.weight": KV,
               "to_out.0.weight": ROW}

    def __init__(self, dim: int, proj_kernel: int, kv_proj_stride: int, heads: int = 8,
                 dim_head: int = 64, dropout: float = 0.0, use_flash: str = "auto", **kw):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.use_flash = heads, dim_head, use_flash
        self.to_q = CvTDepthWiseConv2d(dim, inner, proj_kernel, 1, use_bias=False, **kw)
        self.to_kv = CvTDepthWiseConv2d(dim, 2 * inner, proj_kernel, kv_proj_stride,
                                        use_bias=False, **kw)
        self.to_out = nn.Sequential(Conv(inner, dim, 1, **kw), nn.Dropout(dropout))

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        b, xs, ys, _ = x.shape
        k, v = self.to_kv(x, self.shard).chunk(2, dim=-1)
        q, k, v = (_fold_heads(t, self.heads) for t in (self.to_q(x, self.shard), k, v))
        out = scaled_dot_product_attention(q, k, v, scale=self.dim_head ** -0.5,
                                           use_flash=self.use_flash)
        out = out.permute(0, 2, 1, 3).reshape(b, xs, ys, self.heads * self.dim_head)
        return split_dropout(row_parallel_conv(self.to_out[0], out, self.shard), self.to_out[1],
                             self.shard, generator)


class CvTTransformer(nn.Module):
    """Pre-norm encoder over an NHWC map (``vit_tpu/models/cvt.py:91-122``).
    ``layers[i]`` holds ``attn_norm``, ``attn``, ``mlp_norm``, ``mlp_fc1``
    and ``mlp_fc2`` (``attn_norm_{i}`` … in the Flax tree).  ``shard`` (set
    by ``shard_params``) splits the MLPs by hidden units (``tp_cuts``:
    ``mlp_fc1``'s rows and bias, ``mlp_fc2``'s columns), ``mlp_fc2``'s bias
    added once after the sum.  ``generator``, where given, draws every
    dropout."""

    shard = None

    def __init__(self, dim: int, proj_kernel: int, kv_proj_stride: int, depth: int, heads: int,
                 dim_head: int = 64, mlp_mult: int = 4, dropout: float = 0.0,
                 use_flash: str = "auto", **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.dropout = nn.Dropout(dropout)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "attn_norm": ChannelLayerNorm(dim, **kw),
                "attn": CvTAttention(dim, proj_kernel, kv_proj_stride, heads, dim_head, dropout,
                                     use_flash, generator=gen, **kw),
                "mlp_norm": ChannelLayerNorm(dim, **kw),
                "mlp_fc1": Conv(dim, dim * mlp_mult, 1, generator=gen, **kw),
                "mlp_fc2": Conv(dim * mlp_mult, dim, 1, generator=gen, **kw),
            })
            for _ in range(depth))

    @property
    def tp_cuts(self) -> dict:
        return {f"layers.{i}.mlp_{name}": kind for i in range(len(self.layers))
                for name, kind in (("fc1.weight", COLUMN), ("fc1.bias", COLUMN),
                                   ("fc2.weight", ROW))}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        for layer in self.layers:
            x = x + layer["attn"](layer["attn_norm"](x), generator)
            h = gelu_exact(layer["mlp_fc1"](split_input(layer["mlp_norm"](x), self.shard)))
            h = split_dropout(h, self.dropout, self.shard, generator, hidden=True)
            x = x + split_dropout(row_parallel_conv(layer["mlp_fc2"], h, self.shard),
                                  self.dropout, self.shard, generator)
        return x


class CvT(nn.Module):
    """Constructor parity: ``vit_tpu/models/cvt.py:125-153`` (CvT-13's widths
    by default).  Stage modules ``s{1,2,3}_emb``, ``s{1,2,3}_norm`` and
    ``s{1,2,3}_transformer`` carry the Flax names; ``compute_dtype`` is
    ``vit_tpu``'s ``dtype``, the dtype of the activations."""

    def __init__(self, num_classes: int,
                 s1_emb_dim: int = 64, s1_emb_kernel: int = 7, s1_emb_stride: int = 4,
                 s1_proj_kernel: int = 3, s1_kv_proj_stride: int = 2, s1_heads: int = 1,
                 s1_depth: int = 1, s1_mlp_mult: int = 4,
                 s2_emb_dim: int = 192, s2_emb_kernel: int = 3, s2_emb_stride: int = 2,
                 s2_proj_kernel: int = 3, s2_kv_proj_stride: int = 2, s2_heads: int = 3,
                 s2_depth: int = 2, s2_mlp_mult: int = 4,
                 s3_emb_dim: int = 384, s3_emb_kernel: int = 3, s3_emb_stride: int = 2,
                 s3_proj_kernel: int = 3, s3_kv_proj_stride: int = 2, s3_heads: int = 6,
                 s3_depth: int = 10, s3_mlp_mult: int = 4,
                 dropout: float = 0.0, dtype: torch.dtype | None = None,
                 use_flash: str = "auto", *, compute_dtype: torch.dtype | None = None,
                 channels: int = 3, device=None, generator: torch.Generator | None = None):
        super().__init__()
        if use_flash not in USE_FLASH_MODES:
            raise ValueError(f"use_flash must be one of {USE_FLASH_MODES}, got {use_flash!r}")
        args = locals()
        self.compute_dtype = compute_dtype
        kw = dict(device=resolve_device(device), dtype=dtype)
        dim_in = channels
        for prefix in ("s1", "s2", "s3"):
            cfg = {name: args[f"{prefix}_{name}"] for name in STAGE_FIELDS}
            dim = cfg["emb_dim"]
            self.add_module(f"{prefix}_emb", Conv(dim_in, dim, cfg["emb_kernel"],
                                                  cfg["emb_stride"], generator=generator, **kw))
            self.add_module(f"{prefix}_norm", ChannelLayerNorm(dim, **kw))
            self.add_module(f"{prefix}_transformer", CvTTransformer(
                dim, cfg["proj_kernel"], cfg["kv_proj_stride"], cfg["depth"], cfg["heads"],
                mlp_mult=cfg["mlp_mult"], dropout=dropout, use_flash=use_flash,
                generator=generator, **kw))
            dim_in = dim
        self.head = glorot_linear_(nn.Linear(dim_in, num_classes, **kw), generator)

    def forward(self, img: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``, where given, draws every dropout (a split model's
        active dropout needs one: the ranks draw one mask)."""
        x = img.to(self.compute_dtype or self.head.weight.dtype)
        for prefix in ("s1", "s2", "s3"):
            x = getattr(self, f"{prefix}_emb")(x)
            x = getattr(self, f"{prefix}_norm")(x)
            x = getattr(self, f"{prefix}_transformer")(x, generator)
        return linear(self.head, x.mean(dim=(1, 2)))
