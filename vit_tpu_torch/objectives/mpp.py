"""MPP — BERT-style masked patch prediction (port of
``vit_tpu/objectives/mpp.py``).

A ``mask_prob`` subset of the patches is corrupted — replaced by another
patch of the same image with prob ``random_patch_prob``, by a learned mask
token with prob ``replace_prob`` — and the encoder predicts each masked
patch's mean-colour bucket (``2^(bits·channels)`` classes).  Every draw and
every corruption runs on the model's device.  ``vit_tpu``'s fixes are kept:
the cross-entropy of the predicted logits against the bucket label over the
masked positions (SURVEY §8.7), and the target clamped from above only
(§8.15).  The targets are the pixels, which must lie in ``[0,
max_pixel_val]`` for the buckets to differ.

Randomness: the four draws (the masked subset, the random-patch choice, the
random patches, the mask-token choice) come in ``vit_tpu``'s key order from
one ``torch.Generator`` (see :mod:`vit_tpu_torch.objectives.mae`).  The
encoder keeps ``vit_tpu``'s attribute name, ``transformer``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.layers.common import glorot_linear_, linear
from vit_tpu_torch.models.vit import ViT
from vit_tpu_torch.objectives.mae import mask_generator
from vit_tpu_torch.ops.patchify import patchify


def prob_mask_like(shape, prob: float, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device) < prob


def get_mask_subset_with_prob(batch: int, seq_len: int, prob: float,
                              generator: torch.Generator) -> torch.Tensor:
    """A boolean ``(batch, seq_len)`` mask of the top-⌈prob·seq_len⌉ of
    uniform noise per row (reference mpp.py:78-88)."""
    max_masked = math.ceil(prob * seq_len)
    rand = torch.rand(batch, seq_len, generator=generator, device=generator.device)
    sampled = rand.topk(max_masked, dim=-1).indices
    return torch.zeros(batch, seq_len, dtype=torch.bool, device=rand.device).scatter(
        1, sampled, True)


def randint(generator: torch.Generator, shape, low: int, high: int) -> torch.Tensor:
    """Integers uniform in ``[low, high)``: the random patches' indices,
    ``jax.random.randint`` inline in ``vit_tpu`` (mpp.py:130)."""
    return torch.randint(low, high, shape, generator=generator, device=generator.device)


class MPPLoss(nn.Module):
    """Reference mpp.py:90-131, with the §8.7 and §8.15 fixes.  ``mean`` and
    ``std`` broadcast as ``(-1, 1, 1)`` over the NHWC target, as in
    ``vit_tpu``."""

    def __init__(self, patch_size: int, channels: int, output_channel_bits: int,
                 max_pixel_val: float, mean=None, std=None):
        super().__init__()
        self.patch_size, self.channels = patch_size, channels
        self.output_channel_bits, self.max_pixel_val = output_channel_bits, max_pixel_val
        self.mean, self.std = mean, std

    def forward(self, predicted_patches: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        p, c = self.patch_size, self.channels
        mpv, bits = self.max_pixel_val, self.output_channel_bits
        bin_size = mpv / (2 ** bits)

        target = target.float()
        if self.mean is not None and self.std is not None:
            mean = torch.tensor(self.mean, dtype=torch.float32, device=target.device)
            std = torch.tensor(self.std, dtype=torch.float32, device=target.device)
            target = target * std.reshape(-1, 1, 1) + mean.reshape(-1, 1, 1)

        target = target.clamp(max=mpv)  # from above only (§8.15)
        b, hh, ww, _ = target.shape
        avg_target = target.reshape(b, hh // p, p, ww // p, p, c).mean(dim=(2, 4))
        avg_target = avg_target.reshape(b, -1, c)

        channel_bins = torch.arange(bin_size, mpv, bin_size, device=target.device)
        discretized_target = (avg_target[..., None] >= channel_bins).sum(dim=-1)
        bin_mask = (2 ** bits) ** torch.arange(0, c, device=target.device)
        target_label = (bin_mask * discretized_target).sum(dim=-1)

        logp = F.log_softmax(predicted_patches.float(), dim=-1)
        per_token = -logp.gather(-1, target_label[..., None])[..., 0]
        mask_f = mask.float()
        return (per_token * mask_f).sum() / mask_f.sum().clamp_min(1.0)


class MPP(nn.Module):
    """Constructor parity: reference mpp.py:134-146; plus ``device=``,
    ``dtype=``, ``compute_dtype=`` and ``generator=`` as the port's ViT."""

    def __init__(self, transformer: ViT, patch_size: int, image_size=None, dim=None,
                 output_channel_bits: int = 3, channels: int = 3, max_pixel_val: float = 1.0,
                 mask_prob: float = 0.15, replace_prob: float = 0.5,
                 random_patch_prob: float = 0.5, mean=None, std=None,
                 dtype: torch.dtype | None = None, *, compute_dtype: torch.dtype | None = None,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.transformer, self.patch_size = transformer, patch_size
        self.mask_prob, self.replace_prob = mask_prob, replace_prob
        self.random_patch_prob = random_patch_prob
        self.compute_dtype = compute_dtype
        self.mask_token = nn.Parameter(torch.empty(1, 1, channels * patch_size ** 2, **kw))
        with torch.no_grad():
            nn.init.normal_(self.mask_token, generator=generator)
        self.to_bits = glorot_linear_(
            nn.Linear(transformer.pos_embedding.shape[-1],
                      2 ** (output_channel_bits * channels), **kw), generator)
        self.loss = MPPLoss(patch_size, channels, output_channel_bits, max_pixel_val, mean, std)

    def forward(self, inputs: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        encoder = self.transformer
        img = inputs.detach()
        patches = patchify(img, self.patch_size, self.patch_size)
        batch, seq_len, _ = patches.shape
        g = mask_generator(generator, inputs.device)

        mask = get_mask_subset_with_prob(batch, seq_len, self.mask_prob, g)
        masked_input = patches
        if self.random_patch_prob > 0:
            random_patch_sampling_prob = self.random_patch_prob / (1 - self.replace_prob)
            random_patch_prob = prob_mask_like((batch, seq_len), random_patch_sampling_prob, g)
            bool_random_patch_prob = mask & random_patch_prob
            random_patches = randint(g, (batch, seq_len), 0, seq_len)
            randomized_input = torch.take_along_dim(masked_input, random_patches[..., None],
                                                    dim=1)
            masked_input = torch.where(bool_random_patch_prob[..., None], randomized_input,
                                       masked_input)

        replace_prob = prob_mask_like((batch, seq_len), self.replace_prob, g)
        bool_mask_replace = mask & replace_prob
        masked_input = torch.where(bool_mask_replace[..., None],
                                   self.mask_token.to(masked_input.dtype), masked_input)

        # embed through the encoder protocol (reference mpp.py:200)
        x = encoder.transformer(encoder.emb_dropout(encoder.tokens(masked_input)))

        logits = linear(self.to_bits, x.to(self.compute_dtype or self.to_bits.weight.dtype))
        return self.loss(logits[:, 1:], img, mask)
