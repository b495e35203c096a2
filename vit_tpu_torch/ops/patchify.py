"""Patch extraction and TF-SAME convolution on NHWC maps (port of
``vit_tpu/ops/patchify.py:21-76``).

Images are NHWC, as in ``vit_tpu``, and a patch flattens in ``(p1 p2 c)``
order, so a converted Flax Dense kernel is a plain transpose of the
``nn.Linear`` weight.  The embedding GEMM sits outside every TPU kernel (an
XLA einsum there) and stays ``F.linear`` here.

TF's (and Flax's) ``padding="SAME"`` pads asymmetrically: the odd pad goes
after.  PyTorch's symmetric ``padding=k // 2`` gives the same output shape
and other numbers wherever the total pad is odd (a 7x7 stride-4 conv on 224,
a 3x3 stride-2 conv on an even map), so :func:`conv2d_same` pads with
:func:`same_pads` and convolves without padding.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def patchify(img: torch.Tensor, patch_height: int, patch_width: int) -> torch.Tensor:
    """NHWC image → (b, num_patches, p1·p2·c) tokens, i.e. einops
    ``'b (h p1) (w p2) c -> b (h w) (p1 p2 c)'`` (reference vit.py:142)."""
    b, hh, ww, c = img.shape
    gh, gw = hh // patch_height, ww // patch_width
    x = img.reshape(b, gh, patch_height, gw, patch_width, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, gh * gw, patch_height * patch_width * c)


def patch_embed(img: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                patch_height: int, patch_width: int) -> torch.Tensor:
    """Patchify + linear embedding: NHWC image → (b, n, dim) tokens, with
    ``weight`` in ``nn.Linear`` layout ``(dim, p1·p2·c)``."""
    return F.linear(patchify(img, patch_height, patch_width), weight, bias)


def unpatchify(tokens: torch.Tensor, h: int, w: int, patch_height: int,
               patch_width: int, channels: int) -> torch.Tensor:
    """Inverse of :func:`patchify`."""
    b = tokens.shape[0]
    x = tokens.reshape(b, h, w, patch_height, patch_width, channels)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h * patch_height, w * patch_width, channels)


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """TF 'SAME' padding amounts ``(before, after)`` along one axis: the
    extra pad goes after (``vit_tpu/ops/patchify.py::_same_pads``)."""
    out = -(-size // stride)
    pad = max(0, (out - 1) * stride + kernel - size)
    return pad // 2, pad - pad // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                stride: int = 1, groups: int = 1) -> torch.Tensor:
    """TF-SAME 2-D convolution of an NHWC map ``x`` with an OIHW ``weight``,
    NHWC out, run by ``F.conv2d`` on the zero-copy channels_last view
    ``x.permute(0, 3, 1, 2)``: symmetric pads go to the convolution itself,
    asymmetric ones (:func:`same_pads`) are applied with ``F.pad`` first."""
    (top, bottom), (left, right) = (same_pads(x.shape[1 + i], weight.shape[2 + i], stride)
                                    for i in range(2))
    padding = (top, left)
    if (top, left) != (bottom, right):
        x = F.pad(x, (0, 0, left, right, top, bottom))
        padding = 0
    out = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding, 1, groups)
    return out.permute(0, 2, 3, 1)
