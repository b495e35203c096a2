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
conv-MLPs through the fused MLP kernels.  On the CPU the same ops run their
plain PyTorch versions.  Imports ``torch``, never JAX.
"""

from vit_tpu_torch.core.helpers import cast_params
from vit_tpu_torch.interop.from_flax import state_dict_from_flax
from vit_tpu_torch.models import vit_for_small_dataset
from vit_tpu_torch.models.cvt import CvT
from vit_tpu_torch.models.scalable_vit import ScalableViT
from vit_tpu_torch.models.vit import ViT

__all__ = ["CvT", "ScalableViT", "ViT", "cast_params", "state_dict_from_flax",
           "vit_for_small_dataset"]
