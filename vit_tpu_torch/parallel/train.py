"""The classification train step (port of ``vit_tpu/parallel/train.py``).

One device: the model and its optimizer live on one card.  ``vit_tpu``'s
mesh, sharding rules, buffer donation and ``make_bn_train_step`` come with
the port of ``parallel/mesh.py`` and ``parallel/sharding.py`` (DDP and
tensor parallelism).  The production policy is ``vit_tpu``'s: f32 parameters
with bf16 compute (``ViT(..., compute_dtype=torch.bfloat16)``), so the
gradients and the update are f32.  On the card, the ViT's blocks then run
through the hand-written forward and backward kernels.

    model = ViT(..., compute_dtype=torch.bfloat16)           # on the card
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    metrics = step(images, labels)                           # {"loss", "step"}
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Sparse softmax cross-entropy in f32, mean over the batch."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[:, None]).mean()


@dataclass
class TrainState:
    """What a train step updates: the model's parameters (in place, through
    the optimizer) and the step count."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer) -> TrainState:
    return TrainState(model, optimizer)


def _accum_value_and_grad(loss_of: Callable, params, batch: tuple,
                          accum_steps: int) -> torch.Tensor:
    """Mean loss over ``accum_steps`` microbatches, with the mean gradient
    left in each parameter's ``.grad`` (which must start empty).

    ``batch`` is a tuple of tensors that share the leading batch axis;
    ``loss_of(microbatch) -> scalar``.  As ``vit_tpu``, the gradients are
    summed over the microbatches and divided once, which equals the
    full-batch gradient for mean-reduced losses; only one microbatch of
    activations is alive at a time."""
    size = batch[0].shape[0]
    if any(a.shape[0] != size for a in batch) or size % accum_steps:
        raise ValueError(f"batch of {size} must divide over {accum_steps} accumulation steps")
    total = torch.zeros((), dtype=torch.float32, device=batch[0].device)
    for micro in zip(*(a.chunk(accum_steps) for a in batch)):
        loss = loss_of(micro)
        loss.backward()
        total += loss.detach()
    for p in params:
        if p.grad is not None:
            p.grad.div_(accum_steps)
    return total / accum_steps


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable | None = None, accum_steps: int = 1):
    """Build a classification train step for ``model`` and ``optimizer``.

    Returns ``step(images, labels) -> {"loss": tensor, "step": int}``, which
    puts the model in training mode, computes the mean loss and gradient over
    the batch (over ``accum_steps`` microbatches when above 1), and applies
    one optimizer update.  ``step.state`` is the :class:`TrainState`.
    """
    loss_fn = loss_fn or cross_entropy_loss
    state = create_train_state(model, optimizer)
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def loss_of(batch):
        images, labels = batch
        return loss_fn(model(images), labels)

    def step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accum_steps > 1:
            loss = _accum_value_and_grad(loss_of, params, (images, labels), accum_steps)
        else:
            loss = loss_of((images, labels))
            loss.backward()
            loss = loss.detach()
        optimizer.step()
        state.step += 1
        return {"loss": loss, "step": state.step}

    step.state = state
    return step
