"""PiT: Pooling-based Vision Transformer (port of ``vit_tpu/models/pit.py``).

The image becomes overlapping patches through one VALID convolution of
stride ``patch_size // 2`` (:class:`OverlapPatchEmbed`: 31 x 31 = 961
patches at 224 px, patch 14), a cls token and a learned position embedding
join them, and a stack of stages follows: each stage one
:class:`~vit_tpu_torch.layers.common.Transformer`, then, after every stage
but the last, a :class:`Pool` that doubles the width and halves the map (962
→ 257 → 65 tokens at 224 px).  The head normalises the cls token (eps 1e-3)
and projects it.  Pooling fires after every non-final stage, as in the paper
and in ``vit_tpu`` (its §8.4 fix of the reference's ``not_last``).

Every stage is the port's ``Transformer``, so with 16-bit CUDA activations
each layer runs the block kernels, forward and backward: the fused attention
block (on its mha route past 512 tokens: stage 1's 962) and the fused MLP.
The patch embedding and the pools' convolutions run on cuDNN, as ``vit_tpu``
runs them outside any Pallas kernel.

Constructor: ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the parameter
dtype), ``compute_dtype=`` (``vit_tpu``'s ``dtype``, the activations'),
``generator=``, ``channels=`` (the image's, which Flax infers at init),
``fused_attention=`` and ``fused_mlp=`` (``"auto"`` or ``"never"``, passed
to every stage).  ``scan_layers=True`` raises, as in the ViT.  Images are
NHWC.  The modules carry the Flax names: ``patch_embedding``, ``cls_token``,
``pos_embedding``, ``transformer_{i}`` (with ``layers.{j}``),
``pool_{i}`` with ``cls_ff``, ``downsample_grouped`` and
``downsample_pointwise``, ``head_norm`` and ``head``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import cast_tuple, resolve_device
from vit_tpu_torch.layers.common import (
    Conv, GroupedConv, LayerNorm, Transformer, cast_to, check_fused_mode, glorot_linear_, linear,
)


def conv_output_size(image_size: int, kernel_size: int, stride: int, padding: int = 0) -> int:
    """``vit_tpu/models/pit.py:30``."""
    return int((image_size - kernel_size + 2 * padding) / stride) + 1


class OverlapPatchEmbed(nn.Module):
    """``extract_patches(k, s, VALID)`` and a Dense to ``dim`` as one strided
    convolution (``vit_tpu/models/pit.py:35-66``).

    The parameters keep the Dense's shapes: ``weight`` ``(dim, k·k·c)`` (the
    Flax kernel transposed, its rows in the unfold's ``(kh, kw, c)`` order)
    and ``bias`` ``(dim,)``.  At use the weight is viewed as OIHW and
    ``F.conv2d`` runs on the zero-copy channels_last view of the NHWC image;
    out come ``(b, oh·ow, dim)`` tokens."""

    def __init__(self, dim: int, patch_size: int, stride: int, channels: int = 3, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.patch_size, self.stride, self.channels = patch_size, stride, channels
        self.weight = nn.Parameter(torch.empty(dim, patch_size ** 2 * channels, **kw))
        self.bias = nn.Parameter(torch.zeros(dim, **kw))
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        k, c = self.patch_size, self.channels
        w = cast_to(self.weight, img)
        w = w.view(w.shape[0], k, k, c).permute(0, 3, 1, 2)
        out = F.conv2d(img.permute(0, 3, 1, 2), w, cast_to(self.bias, img), self.stride)
        return out.permute(0, 2, 3, 1).flatten(1, 2)


class Pool(nn.Module):
    """``vit_tpu/models/pit.py:69-91``: the cls token through a Dense
    (``cls_ff``, d → 2d); the other tokens as a square map through a 3 x 3,
    stride-2 TF-SAME convolution with ``groups = d`` (each channel makes two,
    ``downsample_grouped``) and a 1 x 1 one (``downsample_pointwise``)."""

    def __init__(self, dim: int, *, device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.cls_ff = glorot_linear_(nn.Linear(dim, 2 * dim, **kw), generator)
        self.downsample_grouped = GroupedConv(dim, 3, 2, out_channels=2 * dim,
                                              generator=generator, **kw)
        self.downsample_pointwise = Conv(2 * dim, 2 * dim, 1, generator=generator, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        cls_token = linear(self.cls_ff, x[:, :1])
        h = int(math.sqrt(n - 1))
        fmap = x[:, 1:].reshape(b, h, h, c)
        fmap = self.downsample_pointwise(self.downsample_grouped(fmap))
        return torch.cat([cls_token, fmap.flatten(1, 2)], dim=1)


class PiT(nn.Module):
    """Constructor parity: ``vit_tpu/models/pit.py:94-123``."""

    def __init__(self, image_size: int, patch_size: int, num_classes: int, dim: int, depth,
                 heads, mlp_dim: int, dim_head: int = 64, dropout: float = 0.0,
                 emb_dropout: float = 0.0, dtype: torch.dtype | None = None,
                 scan_layers: bool = False, fused_attention: str = "auto",
                 fused_mlp: str = "auto", *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None, channels: int = 3):
        super().__init__()
        # vit_tpu's two asserts, kept under python -O
        if image_size % patch_size:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if not isinstance(depth, tuple):
            raise ValueError("depth must be a tuple of integers, specifying the number of "
                             "blocks before each downsizing")
        if scan_layers:
            raise ValueError(
                "scan_layers=True is a lever on XLA compile time (lax.scan over "
                "stacked layers); PyTorch runs eagerly and has no counterpart")
        fused_attention = check_fused_mode("fused_attention", fused_attention)
        fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.compute_dtype = compute_dtype
        self.stages = len(depth)
        kw = dict(device=resolve_device(device), dtype=dtype)
        heads = cast_tuple(heads, len(depth))

        stride = patch_size // 2
        self.patch_embedding = OverlapPatchEmbed(dim, patch_size, stride, channels,
                                                 generator=generator, **kw)
        num_patches = conv_output_size(image_size, patch_size, stride) ** 2
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.emb_dropout = nn.Dropout(emb_dropout)
        for ind, (layer_depth, layer_heads) in enumerate(zip(depth, heads)):
            self.add_module(f"transformer_{ind}", Transformer(
                dim, layer_depth, layer_heads, dim_head, mlp_dim, dropout, fused_mlp=fused_mlp,
                fused_attention=fused_attention, compute_dtype=compute_dtype,
                generator=generator, **kw))
            if ind < len(depth) - 1:
                self.add_module(f"pool_{ind}", Pool(dim, generator=generator, **kw))
                dim *= 2
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.patch_embedding(img.to(self.compute_dtype or self.head.weight.dtype))
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = self.emb_dropout(x + self.pos_embedding[:, :n + 1].to(x.dtype))
        for ind in range(self.stages):
            x = getattr(self, f"transformer_{ind}")(x)
            if ind < self.stages - 1:
                x = getattr(self, f"pool_{ind}")(x)
        return linear(self.head, self.head_norm(x[:, 0]))
