"""MAE — masked autoencoder objective (port of ``vit_tpu/objectives/mae.py``).

Wraps a built :class:`vit_tpu_torch.models.vit.ViT` encoder through its
encoder protocol.  Masking, the gathers (and their scatter-add backward) and
the decoder run on the model's device; nothing leaves it inside a step.  The
loss is the paper's ``mean((pred − target)²)`` over the masked patches, in
f32 (``vit_tpu``'s SURVEY §8.2 fix).

Randomness: ``forward(img, generator=...)`` draws the masking from that
``torch.Generator`` (on the model's device), the counterpart of the JAX
objective's ``'mask'`` rng; without one, a generator seeded 0 keeps
evaluation deterministic, as ``jax.random.PRNGKey(0)`` does there.

dtypes: the patch vectors enter the encoder's embedding in its compute dtype
(as its ``embed`` casts the pixels); the target stays in the input's dtype.
``compute_dtype`` is ``vit_tpu``'s ``dtype``: the decoder and the heads
compute in it (``None``: the parameter dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import Transformer, cast_to, glorot_linear_, linear
from vit_tpu_torch.models.vit import ViT


def mask_generator(generator: torch.Generator | None, device) -> torch.Generator:
    """``generator``, or one on ``device`` seeded 0 (the JAX objectives'
    ``PRNGKey(0)`` without a ``'mask'`` rng)."""
    return generator if generator is not None else torch.Generator(device=device).manual_seed(0)


def encoder_compute_dtype(encoder: nn.Module) -> torch.dtype:
    """The dtype ``encoder.tokens`` casts the patch vectors to."""
    return encoder.compute_dtype or encoder.patch_embedding.weight.dtype


def random_masking_indices(generator: torch.Generator, batch: int, num_patches: int):
    """argsort of uniform noise (reference mae.py:58), on the generator's
    device; module-level so that tests can inject one draw into both
    packages."""
    noise = torch.rand(batch, num_patches, generator=generator, device=generator.device)
    return noise.argsort(dim=-1)


class MAE(nn.Module):
    """Constructor parity: reference mae.py:18-26; plus ``device=``,
    ``dtype=``, ``compute_dtype=`` and ``generator=`` as the port's ViT."""

    def __init__(self, encoder: ViT, decoder_dim: int, image_size=None,
                 masking_ratio: float = 0.75, decoder_depth: int = 1, decoder_heads: int = 8,
                 decoder_dim_head: int = 64, dtype: torch.dtype | None = None, *,
                 compute_dtype: torch.dtype | None = None, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0 < masking_ratio < 1:
            raise ValueError("masking ratio must be kept between 0 and 1")
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.encoder, self.masking_ratio = encoder, masking_ratio
        self.compute_dtype = compute_dtype
        encoder_dim = encoder.pos_embedding.shape[-1]
        # The reference sizes this from encoder.pos_embedding.shape[-2], which
        # includes the CLS slot (mae.py:36,44): one unused row, kept so that
        # checkpoints line up.
        num_positions = encoder.pos_embedding.shape[-2]
        pixel_values_per_patch = encoder.patch_embedding.in_features
        self.enc_to_dec = (glorot_linear_(nn.Linear(encoder_dim, decoder_dim, **kw), generator)
                           if encoder_dim != decoder_dim else None)
        self.decoder_pos_emb = nn.Embedding(num_positions, decoder_dim, **kw)
        self.mask_token = nn.Parameter(torch.empty(decoder_dim, **kw))
        with torch.no_grad():
            nn.init.normal_(self.decoder_pos_emb.weight, generator=generator)
            nn.init.normal_(self.mask_token, generator=generator)
        self.decoder = Transformer(decoder_dim, decoder_depth, decoder_heads, decoder_dim_head,
                                   decoder_dim * 4, compute_dtype=compute_dtype,
                                   generator=generator, **kw)
        self.to_pixels = glorot_linear_(nn.Linear(decoder_dim, pixel_values_per_patch, **kw),
                                        generator)

    def forward(self, img: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        encoder = self.encoder
        patches = encoder.to_patch(img)
        batch, num_patches, _ = patches.shape
        tokens = encoder.patch_to_emb(patches.to(encoder_compute_dtype(encoder)))
        tokens = tokens + encoder.pos_embedding[:, 1:num_patches + 1].to(tokens.dtype)

        num_masked = int(self.masking_ratio * num_patches)
        rand_indices = random_masking_indices(mask_generator(generator, img.device), batch,
                                              num_patches)
        masked_indices = rand_indices[:, :num_masked]
        unmasked_indices = rand_indices[:, num_masked:]

        tokens = torch.take_along_dim(tokens, unmasked_indices[..., None], dim=1)
        masked_patches = torch.take_along_dim(patches, masked_indices[..., None], dim=1)

        encoded_tokens = encoder.transformer(tokens)
        decoder_tokens = encoded_tokens.to(self.compute_dtype or self.to_pixels.weight.dtype)
        if self.enc_to_dec is not None:
            decoder_tokens = linear(self.enc_to_dec, decoder_tokens)
        pos = cast_to(self.decoder_pos_emb.weight, decoder_tokens)
        decoder_tokens = decoder_tokens + F.embedding(unmasked_indices, pos)
        mask_tokens = cast_to(self.mask_token, decoder_tokens) + F.embedding(masked_indices, pos)

        # mask tokens first, then the visible ones (reference mae.py:82)
        decoded = self.decoder(torch.cat([mask_tokens, decoder_tokens], dim=1))
        pred_pixel_values = linear(self.to_pixels, decoded[:, :num_masked])
        return (pred_pixel_values.float() - masked_patches.float()).square().mean()
