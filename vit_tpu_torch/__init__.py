"""PyTorch / CUDA port of ``vit_tpu`` for NVIDIA Hopper (H100).

Mirrors ``vit_tpu``'s layout and names.  The serving forward of ``ViT`` runs
its transformer blocks through hand-written CUDA kernels on a 16-bit CUDA
model (``vit_tpu_torch/csrc``); on the CPU the same ops run their plain
PyTorch versions.  Imports ``torch``, never JAX.
"""

from vit_tpu_torch.core.helpers import cast_params
from vit_tpu_torch.interop.from_flax import state_dict_from_flax
from vit_tpu_torch.models.vit import ViT

__all__ = ["ViT", "cast_params", "state_dict_from_flax"]
