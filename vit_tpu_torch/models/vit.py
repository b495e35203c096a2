"""ViT — canonical Vision Transformer (port of ``vit_tpu/models/vit.py``).

Same constructor kwargs as ``vit_tpu.ViT`` (reference vit.py:106-177), plus
PyTorch's ``device=`` / ``dtype=``, ``compute_dtype=``, a ``generator=`` for
the initialisation and ``channels=`` (Flax infers the patch width from the
first input).  The model builds on the card unless ``device`` asks for
another.  ``dtype`` is the parameter dtype; ``compute_dtype`` is
``vit_tpu``'s ``dtype``, the dtype of the activations, in which the
embedding, the encoder, the pooling and the head run, with the weights cast
to it in each forward inside autograd.  Training: f32 parameters and
``compute_dtype=torch.bfloat16``, so gradients land in f32 (see
:mod:`vit_tpu_torch.parallel.train`).  ``compute_dtype=None`` computes in the
parameter dtype at call time: serving builds in f32 and
:func:`vit_tpu_torch.cast_params` to bf16.
Images are NHWC ``(b, h, w, c)``, as in ``vit_tpu``.

``fused_attention="hybrid"`` passes ``vit_tpu``'s short-sequence tier to the
encoder (:class:`vit_tpu_torch.layers.common.Transformer`); the parameter
tree is the same on every route.

The encoder protocol (:meth:`to_patch`, :meth:`patch_to_emb`, :meth:`embed`,
``.transformer``, ``.cls_token``, ``.pos_embedding``) is kept for the
self-supervised objectives.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import pair, resolve_device
from vit_tpu_torch.layers.common import LayerNorm, Transformer, glorot_linear_, linear
from vit_tpu_torch.ops.patchify import patchify


class ViT(nn.Module):
    """Constructor parity: reference vit.py:107-108."""

    def __init__(self, image_size, patch_size, num_classes: int, dim: int,
                 depth: int, heads: int, mlp_dim: int, pool: str = "cls",
                 dim_head: int = 64, dropout: float = 0.0, emb_dropout: float = 0.0,
                 dtype: torch.dtype | None = None, scan_layers: bool = False,
                 fused_attention: str = "auto", fused_mlp: str = "auto", *,
                 compute_dtype: torch.dtype | None = None, channels: int = 3,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        image_height, image_width = pair(image_size)
        patch_height, patch_width = pair(patch_size)
        if image_height % patch_height or image_width % patch_width:
            raise ValueError("Image dimensions must be divisible by the patch size.")
        if pool not in {"cls", "mean"}:
            raise ValueError("pool type must be either cls (cls token) or mean (mean pooling)")
        if scan_layers:
            raise ValueError(
                "scan_layers=True is a lever on XLA compile time (lax.scan over "
                "stacked layers); PyTorch runs eagerly and has no counterpart")
        self.patch_size = (patch_height, patch_width)
        self.pool = pool
        self.compute_dtype = compute_dtype
        num_patches = (image_height // patch_height) * (image_width // patch_width)
        patch_dim = patch_height * patch_width * channels
        kw = dict(device=resolve_device(device), dtype=dtype)

        self.patch_embedding = glorot_linear_(nn.Linear(patch_dim, dim, **kw), generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim, **kw))
        self.pos_embedding = nn.Parameter(torch.empty(1, num_patches + 1, dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.cls_token, generator=generator)
            nn.init.normal_(self.pos_embedding, generator=generator)
        self.emb_dropout = nn.Dropout(emb_dropout)
        self.transformer = Transformer(
            dim, depth, heads, dim_head, mlp_dim, dropout=dropout,
            fused_mlp=fused_mlp, fused_attention=fused_attention,
            compute_dtype=compute_dtype, generator=generator, **kw)
        self.head_norm = LayerNorm(dim, **kw)
        self.head = glorot_linear_(nn.Linear(dim, num_classes, **kw), generator)

    # --- encoder protocol (used by MAE / SimMIM / MPP) -------------------
    def to_patch(self, img: torch.Tensor) -> torch.Tensor:
        """Pixels → (b, n, p²·c) patch vectors (reference vit.py:142)."""
        return patchify(img, *self.patch_size)

    def patch_to_emb(self, patches: torch.Tensor) -> torch.Tensor:
        """Patch vectors → tokens via the embedding GEMM, in their dtype."""
        return linear(self.patch_embedding, patches)

    def embed(self, img: torch.Tensor) -> torch.Tensor:
        """patchify → embed → +CLS → +pos → dropout, in the compute dtype."""
        img = img.to(self.compute_dtype or self.patch_embedding.weight.dtype)
        x = self.patch_to_emb(self.to_patch(img))
        b, n, _ = x.shape
        cls_tokens = self.cls_token.to(x.dtype).expand(b, -1, -1)
        x = torch.cat([cls_tokens, x], dim=1)
        x = x + self.pos_embedding[:, : n + 1].to(x.dtype)
        return self.emb_dropout(x)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.transformer(self.embed(img))
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        return linear(self.head, self.head_norm(x))
