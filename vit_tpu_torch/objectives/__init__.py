"""Training objectives (port of ``vit_tpu/objectives``): MAE, SimMIM, MPP and
DeiT distillation, loss modules whose forward is the loss, with their masking
on the model's device.  Train them with
:func:`vit_tpu_torch.parallel.train.make_loss_train_step`."""

from vit_tpu_torch.objectives.distill import (
    DistillableEfficientViT,
    DistillableViT,
    DistillWrapper,
)
from vit_tpu_torch.objectives.mae import MAE
from vit_tpu_torch.objectives.mpp import MPP, MPPLoss
from vit_tpu_torch.objectives.simmim import SimMIM

__all__ = [
    "MAE", "SimMIM", "MPP", "MPPLoss", "DistillWrapper",
    "DistillableViT", "DistillableEfficientViT",
]
