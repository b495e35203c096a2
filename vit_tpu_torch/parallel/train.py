"""The classification train step (port of ``vit_tpu/parallel/train.py``).

The model and its optimizer live on one card per process.  Given ``mesh=``
(:func:`vit_tpu_torch.parallel.mesh.make_mesh`), the step trains
data-parallel over the mesh's ``data`` axis: each process feeds its own
slice of the global batch, the parameters and buffers start equal on every
rank (broadcast from the data axis' first rank when the step is built), the
gradients are averaged over the ranks once a step, after every microbatch,
in one all-reduce (:func:`all_reduce_gradients`), and the BatchNorms
normalise with the global batch statistics
(:func:`vit_tpu_torch.layers.common.synced_batch_norm`), as GSPMD gives them
under ``vit_tpu``'s mesh.  Tensor parallelism (the mesh's ``model`` axis,
``parallel/sharding.py``) is not ported yet.  A model with BatchNorm (CvT)
needs no step of its own: in training mode its forward updates the running
statistics in place, which is what ``vit_tpu``'s ``make_bn_train_step``
returns as ``new_model_state``.  As there, such a model takes no gradient
accumulation.  The production policy is ``vit_tpu``'s: f32 parameters
with bf16 compute (``ViT(..., compute_dtype=torch.bfloat16)``), so the
gradients and the update are f32.  On the card, the ViT's blocks then run
through the hand-written forward and backward kernels.

    model = ViT(..., compute_dtype=torch.bfloat16)           # on the card
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    metrics = step(images, labels)                           # {"loss", "step"}

Data-parallel, one process per card (``torchrun --nproc_per_node=N``):

    initialize_distributed()
    step = make_train_step(model, optimizer, mesh=make_mesh())
    metrics = step(local_images, local_labels)     # the loss is the global mean

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
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.layers.common import synced_batch_norm
from vit_tpu_torch.parallel.mesh import data_group, data_size


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


def broadcast_state(model: nn.Module, group) -> None:
    """Make every parameter and buffer of ``model`` equal to the data axis'
    first rank's: one broadcast of a flat copy per dtype."""
    src = dist.get_global_rank(group, 0)
    by_dtype = {}
    for t in [*model.parameters(), *model.buffers()]:
        by_dtype.setdefault(t.dtype, []).append(t)
    for tensors in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=src, group=group)
        with torch.no_grad():
            for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
                t.copy_(part.view_as(t))


def all_reduce_gradients(params, loss: torch.Tensor, group) -> torch.Tensor:
    """Average ``params``' gradients over ``group``'s ranks and return the
    ranks' mean of ``loss``: one all-reduce of a flat f32 buffer of the
    gradients, a flag a parameter and the loss (another for the gradients of
    each other dtype); each ``.grad`` becomes a view of its buffer.  A
    gradient that a rank did not produce (a head an objective leaves unused,
    a layer CaiT's layer dropout skipped) counts as zero there; a parameter
    that took no gradient on any rank keeps ``.grad`` None, as in one
    process.  That takes a read of the flags on the host, made only by a
    rank that lacks a gradient of its own."""
    world = dist.get_world_size(group)
    present = [p.grad is not None for p in params]
    grads = [p.grad if ok else torch.zeros_like(p) for p, ok in zip(params, present)]
    flags = torch.ones(len(params), device=loss.device) if all(present) else \
        torch.tensor(present, dtype=torch.float32, device=loss.device)
    tail = [flags, loss.detach().float().reshape(1)]
    by_dtype = {torch.float32: []}
    for i, g in enumerate(grads):
        by_dtype.setdefault(g.dtype, []).append(i)
    for dtype, index in by_dtype.items():
        extra = tail if dtype == torch.float32 else []
        flat = torch.cat([grads[i].reshape(-1) for i in index] + extra)
        dist.all_reduce(flat, group=group)
        flat.div_(world)
        parts = flat.split([grads[i].numel() for i in index] + [t.numel() for t in extra])
        for i, part in zip(index, parts):
            grads[i] = part.view_as(grads[i])
        if extra:
            flags, loss = parts[-2], parts[-1].reshape(())
    used = present if all(present) else [u > 0 for u in flags.tolist()]
    for p, g, u in zip(params, grads, used):
        p.grad = g if u else None
    return loss


def _make_step(model: nn.Module, optimizer: torch.optim.Optimizer, loss_of: Callable,
               accum_steps: int, mesh=None) -> Callable:
    """``step(parts, **kw) -> {"loss", "step"}`` for a tuple of batch
    tensors ``parts``: training mode, the mean loss ``loss_of(parts, **kw)``
    and its gradient (over ``accum_steps`` microbatches of every tensor when
    above 1), averaged over ``mesh``'s data axis where given, one optimizer
    update.  ``step.state`` is the :class:`TrainState`."""
    _check_accumulation(model, accum_steps)
    state = create_train_state(model, optimizer)
    params = _optimizer_params(optimizer)
    group = data_group(mesh)
    if group is not None:
        broadcast_state(model, group)
    # The BatchNorms' statistics are global only across ranks: on a data axis
    # of 1 they run as in one process.
    bn_group = group if data_size(mesh) > 1 else None

    def step(parts: tuple, **kw) -> dict:
        def loss_of_parts(micro):
            return loss_of(micro, **kw)

        model.train()
        optimizer.zero_grad(set_to_none=True)
        with synced_batch_norm(model, bn_group):
            if accum_steps > 1:
                loss = _accum_value_and_grad(loss_of_parts, params, parts, accum_steps)
            else:
                loss = loss_of_parts(parts)
                loss.backward()
                loss = loss.detach()
        if group is not None:
            loss = all_reduce_gradients(params, loss, group)
        optimizer.step()
        state.step += 1
        return {"loss": loss, "step": state.step}

    step.state = state
    return step


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    loss_fn: Callable | None = None, accum_steps: int = 1, mesh=None):
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

    ``mesh`` (:func:`~vit_tpu_torch.parallel.mesh.make_mesh`; None: one
    process) trains data-parallel over its ``data`` axis, whatever its size,
    1 included: each rank passes its own slice of the global batch, the
    gradients are averaged once a step after all microbatches, and the
    returned loss is the ranks' mean.  Building the step broadcasts the
    parameters and buffers from the axis' first rank.  ``vit_tpu``'s
    ``donate`` has no counterpart: the update is in place already.
    """
    loss_fn = loss_fn or cross_entropy_loss
    draws = "generator" in inspect.signature(model.forward).parameters

    def loss_of(batch, **kw):
        images, labels = batch
        return loss_fn(model(images, **kw), labels)

    inner = _make_step(model, optimizer, loss_of, accum_steps, mesh)

    def step(images: torch.Tensor, labels: torch.Tensor,
             generator: torch.Generator | None = None) -> dict:
        kw = {"generator": generator} if generator is not None and draws else {}
        return inner((images, labels), **kw)

    step.state = inner.state
    return step


def make_loss_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                         accum_steps: int = 1, mesh=None):
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
    The loss stays on the device.  ``mesh`` as :func:`make_train_step`
    takes it."""
    def loss_of(micro, tupled, **kw):
        return model(micro if tupled else micro[0], **kw)

    inner = _make_step(model, optimizer, loss_of, accum_steps, mesh)

    def step(batch, generator: torch.Generator | None = None) -> dict:
        tupled = isinstance(batch, tuple)
        kw = {} if generator is None else {"generator": generator}
        return inner(batch if tupled else (batch,), tupled=tupled, **kw)

    step.state = inner.state
    return step
