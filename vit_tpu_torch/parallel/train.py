"""The classification train step (port of ``vit_tpu/parallel/train.py``).

One device: the model and its optimizer live on one card.  ``vit_tpu``'s
mesh, sharding rules and buffer donation come with the port of
``parallel/mesh.py`` and ``parallel/sharding.py`` (DDP and tensor
parallelism).  A model with BatchNorm (CvT) needs no step of its own: in
training mode its forward updates the running statistics in place, which is
what ``vit_tpu``'s ``make_bn_train_step`` returns as ``new_model_state``.
As there, such a model takes no gradient accumulation.  The production policy is ``vit_tpu``'s: f32 parameters
with bf16 compute (``ViT(..., compute_dtype=torch.bfloat16)``), so the
gradients and the update are f32.  On the card, the ViT's blocks then run
through the hand-written forward and backward kernels.

    model = ViT(..., compute_dtype=torch.bfloat16)           # on the card
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    metrics = step(images, labels)                           # {"loss", "step"}

A model that draws in training (dropout and stochastic depth in ``CCT``,
layer dropout in ``CaiT``, ATS-ViT's Gumbel noise) takes its draws from the
``generator`` given to the step, ``vit_tpu``'s ``rng``:

    metrics = step(images, labels, generator=torch.Generator("cuda").manual_seed(0))

:func:`make_loss_train_step` is the step of a module whose forward is the
loss (the objectives of :mod:`vit_tpu_torch.objectives`):

    mae = MAE(ViT(..., compute_dtype=torch.bfloat16), decoder_dim=512,
              compute_dtype=torch.bfloat16)
    step = make_loss_train_step(mae, torch.optim.AdamW(mae.parameters(), lr=1e-4))
    metrics = step(images, generator=torch.Generator("cuda").manual_seed(0))
"""

from __future__ import annotations

import inspect
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


def _check_accumulation(model: nn.Module, accum_steps: int) -> None:
    if accum_steps > 1 and any(name.endswith("running_mean")
                               for name, _ in model.named_buffers()):
        raise ValueError("accum_steps > 1 on a model with BatchNorm statistics: they would "
                         "be updated once per microbatch (vit_tpu's make_bn_train_step "
                         "takes no accumulation)")


def _optimizer_params(optimizer: torch.optim.Optimizer) -> list:
    return [p for group in optimizer.param_groups for p in group["params"]]


def _make_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss_of: Callable,
               accum_steps: int) -> Callable:
    """``step(parts, **kw) -> {"loss", "step"}`` for a tuple of batch
    tensors ``parts``: training mode, the mean loss ``loss_of(parts, **kw)``
    and its gradient (over ``accum_steps`` microbatches of every tensor when
    above 1), one optimizer update.  ``step.state`` is the
    :class:`TrainState`."""
    _check_accumulation(model, accum_steps)
    state = create_train_state(model, optimizer)
    params = _optimizer_params(optimizer)

    def step(parts: tuple, **kw) -> dict:
        def loss_of_parts(micro):
            return loss_of(micro, **kw)

        model.train()
        optimizer.zero_grad(set_to_none=True)
        if accum_steps > 1:
            loss = _accum_value_and_grad(loss_of_parts, params, parts, accum_steps)
        else:
            loss = loss_of_parts(parts)
            loss.backward()
            loss = loss.detach()
        optimizer.step()
        state.step += 1
        return {"loss": loss, "step": state.step}

    step.state = state
    return step


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable | None = None, accum_steps: int = 1):
    """Build a classification train step for ``model`` and ``optimizer``.

    Returns ``step(images, labels, generator=None) -> {"loss": tensor,
    "step": int}``, which puts the model in training mode, computes the mean
    loss and gradient over the batch (over ``accum_steps`` microbatches when
    above 1), and applies one optimizer update.  ``generator``, where given,
    goes to the forward as its ``generator=`` (the draws of dropout,
    stochastic depth, layer dropout or token sampling; ``vit_tpu``'s step
    takes an ``rng``), the microbatches drawing from it in turn, as in
    :func:`make_loss_train_step`; a model whose forward takes no generator
    is called without one.  ``step.state`` is the :class:`TrainState`.
    ``accum_steps > 1`` on a model with BatchNorm running statistics raises
    ``ValueError``: they would be updated once per microbatch, and
    ``vit_tpu``'s BatchNorm step offers no accumulation.
    """
    loss_fn = loss_fn or cross_entropy_loss
    draws = "generator" in inspect.signature(model.forward).parameters

    def loss_of(batch, **kw):
        images, labels = batch
        return loss_fn(model(images, **kw), labels)

    inner = _make_step(model, optimizer, loss_of, accum_steps)

    def step(images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None) -> dict:
        kw = {"generator": generator} if generator is not None and draws else {}
        return inner((images, labels), **kw)

    step.state = inner.state
    return step


def make_loss_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                         accum_steps: int = 1):
    """The train step of a module whose forward is the loss (MAE, SimMIM,
    MPP, ``DistillWrapper``; ``vit_tpu/parallel/train.py:143-177``).

    Returns ``step(batch, generator=None) -> {"loss": tensor, "step": int}``:
    ``batch`` is what the module's forward takes first (a tensor of images, or
    ``DistillWrapper``'s ``(images, labels)`` tuple); ``generator``, where
    given, goes to the forward as its ``generator=`` (the masking draws, the
    JAX step's ``rng``).  As :func:`make_train_step`: training mode, the mean
    loss and gradient over the batch (over ``accum_steps`` microbatches of
    every tensor in ``batch`` when above 1, drawing from ``generator`` in
    turn), one optimizer update; ``step.state`` is the :class:`TrainState`.
    The loss stays on the device."""
    def loss_of(micro, tupled, **kw):
        return model(micro if tupled else micro[0], **kw)

    inner = _make_step(model, optimizer, loss_of, accum_steps)

    def step(batch, generator: torch.Generator | None = None) -> dict:
        tupled = isinstance(batch, tuple)
        kw = {} if generator is None else {"generator": generator}
        return inner(batch if tupled else (batch,), tupled=tupled, **kw)

    step.state = inner.state
    return step
