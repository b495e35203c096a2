"""Patch extraction (port of ``vit_tpu/ops/patchify.py:21-69``).

Images are NHWC, as in ``vit_tpu``, and a patch flattens in ``(p1 p2 c)``
order, so a converted Flax Dense kernel is a plain transpose of the
``nn.Linear`` weight.  The embedding GEMM sits outside every TPU kernel (an
XLA einsum there) and stays ``F.linear`` here.
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
