"""PyTorch / CUDA port of ``vit_tpu`` for NVIDIA Hopper (H100).

Mirrors ``vit_tpu``'s layout and names.  ``ViT`` serves and trains on the
card: with 16-bit activations its transformer blocks run through hand-written
CUDA kernels, forward and backward (``vit_tpu_torch/csrc``), and
``vit_tpu_torch.parallel.train.make_train_step`` takes an f32-parameter,
bf16-compute train step.  ``vit_tpu_torch.models.vit_for_small_dataset.ViT``
(SPT + LSA) does both as well, its LSA through the biased attention-block
kernel.  ``CvT`` (CvT-13 by default) does both with its stage-1 attention
(stages 1 and 2 at 384 px) through the hand-written flash-attention kernels,
forward and backward.  ``ScalableViT`` does both with its SSA through the
fused cross-attention kernels and its IWSA (at 1024-token windows and above)
through the channel-packed flash kernel, forward and backward, and its
conv-MLPs through the fused MLP kernels.  ``T2TViT`` does both with its
token transformers on the same kernels as ``vit_tpu``'s: the first one's
attention (one head of 147 over 3136 tokens, padded to 192) through the flash
kernels, both token MLPs (147 and 1323 wide) through the fused MLP kernels,
its encoder through the block kernels.  ``TwinsSVT`` does both with its
local attention over 7 x 7 windows folded into the batch through the block
kernels (49 tokens, eps 1e-5), its reduced global attention through the
fused cross-attention kernels (8 heads of 64 over 64, 16, 4 and 1 keys),
and its conv-MLPs through the fused MLP kernels.  ``CrossFormer`` does both
with its short (7 x 7) and long (dilated) window attentions through the
biased block kernels (dim_head 32, its dynamic position bias as the shared
logits bias and its gradient as the kernel's dbias; windows of fewer than 8
tokens on the plain modules, as in ``vit_tpu``) and its MLPs, which keep
their LayerNorm inside, through the fused MLP kernels.  ``RegionViT`` does
both with both attentions of every layer through the block kernels (dim_head
32): the region self-attention unbiased (64, 16, 4 and 1 tokens an image at
224 px), the joint attention of each region token and its 7 x 7 window
biased by its per-head relative position table, whose gradient comes back
as the kernel's dbias; its MLPs stay plain, as in ``vit_tpu``.  ``NesT`` does
both with the attention of every transformer layer through the block kernels
over its blocks folded into the batch (196 tokens a block at 224 px, patch 4,
dim_head 32, eps 1e-5) and its MLPs, loose pairs of 1x1 convolutions,
through the fused MLP kernels.  ``PiT`` does both with every layer of its
three stages on the block kernels, forward and backward: stage 1's 962
tokens (224 px, patch 14, stride 7) take the attention block's route past
512 tokens, stages 2 and 3 (257 and 65 tokens, twice and four times as wide
after each pool) its short route; its overlapping patch embedding and its
pools' grouped convolutions run on cuDNN.  ``LeViT`` and ``MobileViT`` do
both on plain modules, as ``vit_tpu`` runs no Pallas kernel in either: their
BatchNorms are the port's Flax-parity ``BatchNorm``, their convolutions run
on cuDNN and their attentions keep ``vit_tpu``'s f32 softmax.  ``DeepViT``,
``vit_with_patch_merger.ViT`` and ``CrossViT`` do both with every MLP (each
of CrossViT's encoders' MLPs) through the fused MLP kernels, forward and
backward, and their attentions plain, as in ``vit_tpu``: DeepViT's
re-attention over its f32 matrix, the patch merger's ViT's plain attention
and its f32 merger softmax, CrossViT's cross attention below the flash tier.
``CaiT`` and ``parallel_vit.ViT`` do both on plain modules, as ``vit_tpu``
runs no Pallas kernel in either.  ``ats_vit.ViT`` (ATS-ViT) does both with
its token sampling on the card at static shapes (the Gumbel draws from the
forward's generator) and its attention plain, as in ``vit_tpu``; its MLPs
run plain by default (``fused_mlp="never"``, ``vit_tpu``'s default) and
through the fused MLP kernels, forward and backward, with
``fused_mlp="auto"``.  ``CCT`` (and ``cct_2`` … ``cct_16``) does both on
plain modules, as ``vit_tpu`` runs no Pallas kernel in it: its convolutional
tokenizer on cuDNN, its dropout and stochastic depth drawn from the
forward's generator.  A model that draws in training takes its generator
from ``make_train_step``'s ``step(images, labels, generator=g)``.  The Efficient ViT
(``vit_tpu_torch.models.efficient.ViT``) takes any encoder; the port's
``Transformer`` runs the same block kernels there.  The training objectives (``MAE``, ``SimMIM``, ``MPP``,
``DistillWrapper`` over the ``Distillable*`` students, ``DistillableT2TViT``
among them) train with
``vit_tpu_torch.parallel.train.make_loss_train_step``.  Both steps train
data-parallel over ``parallel.mesh.make_mesh()``'s ``data`` axis, one
process per card; ``interop.checkpoint`` saves and resumes, ``interop.export``
exports a serving forward with ``torch.export`` (the kernel entries are
registered ops), and ``utils`` holds the input pipeline and the debug,
metrics and profiling tools (``docs/TORCH.md``).  On the CPU the same
ops run their plain PyTorch versions.  Imports ``torch``, never JAX.
"""

from vit_tpu_torch.core.helpers import cast_params
from vit_tpu_torch.interop.from_flax import state_dict_from_flax
from vit_tpu_torch.models import (
    ats_vit, parallel_vit, vit_for_small_dataset, vit_with_patch_merger,
)
from vit_tpu_torch.models.cait import CaiT
from vit_tpu_torch.models.cct import CCT, cct_2, cct_4, cct_6, cct_7, cct_8, cct_14, cct_16
from vit_tpu_torch.models.cross_vit import CrossViT
from vit_tpu_torch.models.crossformer import CrossFormer
from vit_tpu_torch.models.cvt import CvT
from vit_tpu_torch.models.deepvit import DeepViT
from vit_tpu_torch.models.levit import LeViT
from vit_tpu_torch.models.mobile_vit import MobileViT
from vit_tpu_torch.models.nest import NesT
from vit_tpu_torch.models.pit import PiT
from vit_tpu_torch.models.regionvit import RegionViT
from vit_tpu_torch.models.scalable_vit import ScalableViT
from vit_tpu_torch.models.t2t import T2TViT
from vit_tpu_torch.models.twins_svt import TwinsSVT
from vit_tpu_torch.models.vit import ViT
from vit_tpu_torch.models.vit_for_small_dataset import LSA, SPT
from vit_tpu_torch.models.vit_with_patch_merger import PatchMerger
from vit_tpu_torch.objectives.distill import (
    DistillableEfficientViT, DistillableT2TViT, DistillableViT, DistillWrapper,
)
from vit_tpu_torch.objectives.mae import MAE
from vit_tpu_torch.objectives.mpp import MPP
from vit_tpu_torch.objectives.simmim import SimMIM

# vit_tpu's names but its JAX-only bind, BoundModel and enable_compile_cache,
# then the port's own.
__all__ = [
    "cast_params",
    "ViT", "DeepViT", "CaiT", "CrossViT", "SPT", "LSA", "PatchMerger",
    "T2TViT", "PiT", "CCT", "LeViT", "CvT", "TwinsSVT", "CrossFormer",
    "RegionViT", "ScalableViT", "NesT", "MobileViT",
    "cct_2", "cct_4", "cct_6", "cct_7", "cct_8", "cct_14", "cct_16",
    "MAE", "SimMIM", "MPP", "DistillWrapper",
    "DistillableViT", "DistillableT2TViT", "DistillableEfficientViT",
    "state_dict_from_flax", "ats_vit", "parallel_vit", "vit_for_small_dataset",
    "vit_with_patch_merger",
]
