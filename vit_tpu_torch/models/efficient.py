""""Efficient" ViT — a ViT shell with an injectable encoder (port of
``vit_tpu/models/efficient.py``).

Any module that maps ``(b, n, dim)`` tokens to tokens serves as the encoder
(``transformer``), as in ``vit_tpu``: the port's ``Transformer`` takes the
hand-written block kernels.  No embedding dropout, matching the reference.
Constructor kwargs as ``vit_tpu``'s, plus ``device=``, ``dtype=`` (the
parameter dtype), ``compute_dtype=``, ``generator=`` and ``channels=``, as
the port's :class:`~vit_tpu_torch.models.vit.ViT`.  Images are NHWC.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import pair, resolve_device
from vit_tpu_torch.layers.common import LayerNorm, glorot_linear_, linear
from vit_tpu_torch.ops.patchify import patchify


class ViT(nn.Module):
    """Constructor parity: reference efficient.py:14."""

    def __init__(self, image_size, patch_size: int, num_classes: int, dim: int,
                 transformer: nn.Module, pool: str = "cls", dtype: torch.dtype | None = None,
                 *, compute_dtype: torch.dtype | None = None, channels: int = 3, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        h, w = pair(image_size)
        if h % patch_size or w % patch_size:
            raise ValueError("image dimensions must be divisible by the patch size")
        if pool not in {"cls", "mean"}:
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        self.pool = pool
        self.patch_size, self.compute_dtype = patch_size, compute_dtype
        num_patches = (h // patch_size) * (w // patch_size)
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.patch_embedding = glorot_linear_(
            nn.Linear(patch_size * patch_size * channels, dim, **kw), generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.transformer = transformer
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """patchify → embed → +CLS → +pos, in the compute dtype."""
        img = img.to(self.compute_dtype or self.patch_embedding.weight.dtype)
        x = linear(self.patch_embedding, patchify(img, self.patch_size, self.patch_size))
        b, n, _ = x.shape
        x = torch.cat([self.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        return x + self.pos_embedding[:, : n + 1].to(x.dtype)

    def pool_head(self, x: torch.Tensor) -> torch.Tensor:
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return linear(self.head, self.head_norm(x))

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return self.pool_head(self.transformer(self.embed(img)))
