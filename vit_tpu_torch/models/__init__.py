"""Models of the PyTorch port (mirrors vit_tpu.models).

Several files name their model class ``ViT`` (parallel_vit.py,
vit_with_patch_merger.py, vit_for_small_dataset.py, efficient.py); import
those via their module, as ``vit_tpu.models`` does.
"""

from vit_tpu_torch.models import parallel_vit, vit_with_patch_merger
from vit_tpu_torch.models.cait import CaiT
from vit_tpu_torch.models.cross_vit import CrossViT
from vit_tpu_torch.models.crossformer import CrossFormer
from vit_tpu_torch.models.deepvit import DeepViT
from vit_tpu_torch.models.levit import LeViT
from vit_tpu_torch.models.mobile_vit import MobileViT
from vit_tpu_torch.models.nest import NesT
from vit_tpu_torch.models.pit import PiT
from vit_tpu_torch.models.regionvit import RegionViT
from vit_tpu_torch.models.twins_svt import TwinsSVT
from vit_tpu_torch.models.vit_with_patch_merger import PatchMerger

__all__ = ["parallel_vit", "vit_with_patch_merger", "CaiT", "CrossFormer", "CrossViT", "DeepViT",
           "LeViT", "MobileViT", "NesT", "PatchMerger", "PiT", "RegionViT", "TwinsSVT"]
