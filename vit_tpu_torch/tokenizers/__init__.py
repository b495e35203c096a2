"""Tokenizers / embedders — the single import point (port of
``vit_tpu/tokenizers/__init__.py``):

- linear patchify: :func:`patchify` / :func:`unpatchify` (+ the ViT's
  ``patch_embedding`` GEMM);
- unfold tokenizer: :func:`extract_patches` (``tf.image.extract_patches``
  semantics; T2T-ViT's, :class:`vit_tpu_torch.models.t2t.T2TViT`);
- shifted-patch tokenization: :class:`SPT` (the small-dataset ViT's);
- space-to-depth patch merging: :class:`PatchEmbedding` (Twins-SVT's,
  ``(c p1 p2)`` channel order, then a 1x1 convolution);
- cross-scale embedding: :class:`CrossEmbedLayer` (CrossFormer's,
  convolutions of several kernel sizes at one stride, merged into one);
- overlapping patches: :class:`OverlapPatchEmbed` (PiT's, the unfold at
  stride ``patch_size // 2`` and its Dense as one strided convolution);
- conv-BN stem: :class:`ConvNxNBN` (MobileViT's, a TF-SAME convolution
  without bias, BatchNorm and SiLU); LeViT's stem of four 3x3 stride-2
  convolutions lives inside :class:`vit_tpu_torch.models.levit.LeViT`
  (``conv_embedding_{i}``).
"""

from vit_tpu_torch.models.crossformer import CrossEmbedLayer
from vit_tpu_torch.models.mobile_vit import ConvNxNBN
from vit_tpu_torch.models.pit import OverlapPatchEmbed
from vit_tpu_torch.models.twins_svt import PatchEmbedding
from vit_tpu_torch.models.vit_for_small_dataset import SPT
from vit_tpu_torch.ops.patchify import extract_patches, patchify, unpatchify

__all__ = ["patchify", "unpatchify", "extract_patches", "SPT", "PatchEmbedding",
           "CrossEmbedLayer", "OverlapPatchEmbed", "ConvNxNBN"]
