"""PyTorch / CUDA port of ``vit_tpu`` for NVIDIA Hopper (H100).

Mirrors ``vit_tpu``'s layout and names.  ``ViT`` serves and trains on the
card: with 16-bit activations its transformer blocks run through hand-written
CUDA kernels, forward and backward (``vit_tpu_torch/csrc``), and
``vit_tpu_torch.parallel.train.make_train_step`` takes an f32-parameter,
bf16-compute train step.  ``vit_tpu_torch.models.vit_for_small_dataset.ViT``
(SPT + LSA) does both as well, its LSA through the biased attention-block
kernel.  On the CPU the same ops run their plain PyTorch versions.  Imports
``torch``, never JAX.
"""

from vit_tpu_torch.core.helpers import cast_params
from vit_tpu_torch.interop.from_flax import state_dict_from_flax
from vit_tpu_torch.models import vit_for_small_dataset
from vit_tpu_torch.models.vit import ViT

__all__ = ["ViT", "cast_params", "state_dict_from_flax", "vit_for_small_dataset"]
