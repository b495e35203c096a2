"""Serving export: a model's forward as a ``torch.export`` artifact (port of
``vit_tpu/interop/export.py``).

``vit_tpu`` captures the traced forward as StableHLO with ``jax.export``.
Here :func:`export_forward` traces the eval-mode forward under
``torch.no_grad()`` with ``torch.export.export`` and serialises the program
with ``torch.export.save``; :func:`load_forward` gives back a module that runs
it without the model's code.  Without autograd every kernel entry of the
port is a registered op (``vit_tpu_torch::fused_mlp``,
``::fused_attention_block``, ``::fused_attention_block_bias``,
``::fused_cross_attention``, ``::flash_attention``,
``::flash_attention_packed``, ``::short_attention``, ``::ln_gemm``,
``::attention_nb``, ``::proj_mlp``), which the program holds as one node
each: an artifact exported from a model on the card launches the
hand-written kernels when it runs, and the loading process imports
``vit_tpu_torch`` to register them, as a ``vit_tpu`` artifact exported on a
TPU host holds the kernels as TPU custom calls.  ``vit_tpu``'s
``platforms=`` has no counterpart: the program runs where its model was.

Two layouts:

* ``bake_params=False`` (default): the artifact is a function of ``(params,
  image)``, ``params`` the model's ``named_parameters()`` and
  ``named_buffers()`` as one dict; the weights stay in checkpoints and one
  artifact serves every checkpoint of a run.
* ``bake_params=True``: the weights are inside; one self-contained file (cast
  them first with :func:`vit_tpu_torch.cast_params` for the serving dtype).

The loaded program takes only the shapes it was exported at, as ``jax.export``'s.

A model split over a ``model`` axis above 1
(:func:`vit_tpu_torch.parallel.sharding.shard_params`) does not export: its
blocks sum partials over a process group, which a program cannot hold.
Restore its checkpoint (written whole) into an unsharded model and export
that.
"""

from __future__ import annotations

import importlib
import io
from typing import Sequence

import torch
from torch import nn


# The modules that register the kernel ops an artifact may hold.
OP_MODULES = ("fused_mlp", "fused_attention_block", "fused_cross_attention", "flash_attention",
              "flash_attention_packed", "short_attention", "fused_hybrid")


def _first(out):
    return out[0] if isinstance(out, tuple) else out


class _Baked(nn.Module):
    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, image):
        return _first(self.model(image))


class _Functional(nn.Module):
    """``forward(params, image)`` of a model it does not register, so that
    the program holds none of its tensors."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.__dict__["_model"] = model

    def forward(self, params, image):
        return _first(torch.func.functional_call(self._model, params, (image,)))


def model_params(model: nn.Module) -> dict:
    """The ``params`` an unbaked artifact takes: every parameter and buffer
    of ``model`` by its ``state_dict`` name."""
    return {**dict(model.named_parameters()), **dict(model.named_buffers())}


def _device(model: nn.Module) -> torch.device:
    return next(iter(model_params(model).values())).device


def export_forward(model: nn.Module, image_shape: Sequence[int], *,
                   dtype: torch.dtype = torch.float32, bake_params: bool = False) -> bytes:
    """Serialise ``model``'s serving forward on ``image_shape`` inputs (the
    full shape, batch included, e.g. ``(64, 224, 224, 3)``) of ``dtype``.

    The model is traced in eval mode under ``torch.no_grad()``, so that its
    kernel entries are the registered ops, on its own device; its training
    mode is restored afterwards.  A tuple output is cut to its first
    element.  Returns the bytes of ``torch.export.save``; load them with
    :func:`load_forward`.  A model split over a ``model`` axis above 1
    raises ``ValueError``."""
    from vit_tpu_torch.parallel.sharding import tensor_parallel_plan

    plan = tensor_parallel_plan(model)
    if plan is not None and plan.shard.size > 1:
        raise ValueError(f"export_forward: the model is split over a 'model' axis of "
                         f"{plan.shard.size}; export from an unsharded model (restore its "
                         f"checkpoint, which holds it whole, into one)")
    image = torch.zeros(tuple(image_shape), dtype=dtype, device=_device(model))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            if bake_params:
                program = torch.export.export(_Baked(model), (image,))
            else:
                program = torch.export.export(_Functional(model), (model_params(model), image))
    finally:
        model.train(was_training)
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()


def load_forward(data: bytes) -> nn.Module:
    """The module of :func:`export_forward`'s bytes: ``f(params, image)``, or
    ``f(image)`` for an artifact exported with ``bake_params=True``.  Call
    it under ``torch.no_grad()`` (or ``torch.inference_mode()``)."""
    for name in OP_MODULES:
        importlib.import_module(f"vit_tpu_torch.ops.{name}")
    return torch.export.load(io.BytesIO(data)).module()


def save_forward(path: str, *args, **kwargs) -> None:
    """:func:`export_forward` straight to ``path``."""
    data = export_forward(*args, **kwargs)
    with open(path, "wb") as f:
        f.write(data)


def load_forward_file(path: str) -> nn.Module:
    """:func:`load_forward` from ``path``."""
    with open(path, "rb") as f:
        return load_forward(f.read())
