"""SimMIM — simple masked image modeling (port of
``vit_tpu/objectives/simmim.py``).

Token-replacement masking: the top-k of uniform noise picks the masked
positions, a learned mask token (+pos emb) replaces them, the full sequence
(no CLS) encodes, and a linear head reconstructs the masked patches' pixels.
The scatter of the mask and the gathers run on the model's device.  The loss
keeps the reference's ``mean(|pred − target|) / num_masked`` (simmim.py:128),
in f32.  Randomness and dtypes as in :mod:`vit_tpu_torch.objectives.mae`.
"""

from __future__ import annotations

import torch
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import cast_to, glorot_linear_, linear
from vit_tpu_torch.models.vit import ViT
from vit_tpu_torch.objectives.mae import encoder_compute_dtype, mask_generator


def masked_topk_indices(generator: torch.Generator, batch: int, num_patches: int,
                        num_masked: int):
    """Top-k of uniform noise (reference simmim.py:108), on the generator's
    device; module-level so that tests can inject one draw into both
    packages."""
    noise = torch.rand(batch, num_patches, generator=generator, device=generator.device)
    return noise.topk(num_masked, dim=-1).indices


class SimMIM(nn.Module):
    """Constructor parity: reference simmim.py:68; plus ``device=``,
    ``dtype=``, ``compute_dtype=`` and ``generator=`` as the port's ViT."""

    def __init__(self, encoder: ViT, image_size=None, masking_ratio: float = 0.5,
                 dtype: torch.dtype | None = None, *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        if not 0 < masking_ratio < 1:
            raise ValueError("masking ratio must be kept between 0 and 1")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.encoder, self.masking_ratio = encoder, masking_ratio
        self.compute_dtype = compute_dtype
        dim = encoder.pos_embedding.shape[-1]
        self.mask_token = nn.Parameter(torch.empty(dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.mask_token, generator=generator)
        self.to_pixels = glorot_linear_(
            nn.Linear(dim, encoder.patch_embedding.in_features, **kw), generator)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        encoder = self.encoder
        patches = encoder.to_patch(img)
        batch, num_patches, _ = patches.shape
        tokens = encoder.patch_to_emb(patches.to(encoder_compute_dtype(encoder)))
        pos_emb = encoder.pos_embedding[:, 1:num_patches + 1].to(tokens.dtype)
        mask_tokens = cast_to(self.mask_token, tokens) + pos_emb
        tokens = tokens + pos_emb

        num_masked = int(self.masking_ratio * num_patches)
        masked_indices = masked_topk_indices(mask_generator(generator, img.device), batch,
                                             num_patches, num_masked)
        masked = torch.zeros(batch, num_patches, dtype=torch.bool, device=img.device)
        masked = masked.scatter(1, masked_indices, True)
        tokens = torch.where(masked[..., None], mask_tokens, tokens)

        encoded = encoder.transformer(tokens)
        encoded_mask_tokens = torch.take_along_dim(encoded, masked_indices[..., None], dim=1)
        pred_pixel_values = linear(self.to_pixels, encoded_mask_tokens.to(
            self.compute_dtype or self.to_pixels.weight.dtype))
        masked_patches = torch.take_along_dim(patches, masked_indices[..., None], dim=1)
        return (pred_pixel_values.float() - masked_patches.float()).abs().mean() / num_masked
