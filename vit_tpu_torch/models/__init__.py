"""Models of the PyTorch port (mirrors vit_tpu.models)."""

from vit_tpu_torch.models.crossformer import CrossFormer
from vit_tpu_torch.models.levit import LeViT
from vit_tpu_torch.models.mobile_vit import MobileViT
from vit_tpu_torch.models.nest import NesT
from vit_tpu_torch.models.pit import PiT
from vit_tpu_torch.models.regionvit import RegionViT
from vit_tpu_torch.models.twins_svt import TwinsSVT

__all__ = ["CrossFormer", "LeViT", "MobileViT", "NesT", "PiT", "RegionViT", "TwinsSVT"]
