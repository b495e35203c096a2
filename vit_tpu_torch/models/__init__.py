"""Models of the PyTorch port (mirrors vit_tpu.models): one module per
``vit_tpu`` model file, the same public names.

Several files name their model class ``ViT`` (efficient.py, parallel_vit.py,
ats_vit.py, vit_for_small_dataset.py, vit_with_patch_merger.py); import
those via their module, as ``vit_tpu.models`` does.
"""

from vit_tpu_torch.models import (
    ats_vit,
    cait,
    cct,
    cross_vit,
    crossformer,
    cvt,
    deepvit,
    efficient,
    levit,
    mobile_vit,
    nest,
    parallel_vit,
    pit,
    regionvit,
    scalable_vit,
    t2t,
    twins_svt,
    vit,
    vit_for_small_dataset,
    vit_with_patch_merger,
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

__all__ = [
    # modules
    "vit", "efficient", "deepvit", "cait", "parallel_vit", "cross_vit",
    "vit_for_small_dataset", "vit_with_patch_merger", "t2t", "pit", "cct",
    "levit", "cvt", "twins_svt", "crossformer", "regionvit", "scalable_vit",
    "nest", "mobile_vit", "ats_vit",
    # classes
    "ViT", "DeepViT", "CaiT", "CrossViT", "SPT", "LSA", "PatchMerger",
    "T2TViT", "PiT", "CCT", "LeViT", "CvT", "TwinsSVT", "CrossFormer",
    "RegionViT", "ScalableViT", "NesT", "MobileViT",
    "cct_2", "cct_4", "cct_6", "cct_7", "cct_8", "cct_14", "cct_16",
]
