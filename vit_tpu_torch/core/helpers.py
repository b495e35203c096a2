"""Shared config helpers (port of ``vit_tpu/core/helpers.py``)."""

from __future__ import annotations

import torch
from torch import nn


def pair(t):
    """Broadcast a scalar to an (h, w) tuple (reference vit.py:11-12)."""
    return t if isinstance(t, tuple) else (t, t)


def cast_tuple(val, length: int = 1) -> tuple:
    """A scalar repeated ``length`` times; a tuple as it is."""
    return val if isinstance(val, tuple) else (val,) * length


def exists(val) -> bool:
    return val is not None


def default(val, d):
    return val if exists(val) else d


def group_dict_by_key(cond, d: dict):
    """``(matching, rest)``: the items of ``d`` whose key ``cond`` holds for,
    and the others."""
    return_val = [dict(), dict()]
    for key in d.keys():
        return_val[int(not bool(cond(key)))][key] = d[key]
    return (*return_val,)


def group_by_key_prefix(prefix: str, d: dict):
    return group_dict_by_key(lambda x: x.startswith(prefix), d)


def group_by_key_prefix_and_remove_prefix(prefix: str, d: dict):
    """The ``prefix``-prefixed kwargs of ``d`` with the prefix stripped, and
    the others (reference cvt.py:10-21: CvT's and Twins-SVT's per-stage
    kwargs)."""
    kwargs_with_prefix, kwargs = group_by_key_prefix(prefix, d)
    return {k[len(prefix):]: v for k, v in kwargs_with_prefix.items()}, kwargs


def divisible_by(numer: int, denom: int) -> bool:
    return (numer % denom) == 0


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating-point parameters of ``module`` to ``dtype`` once, in
    place, and return it (serving: keep bf16 weights resident instead of
    converting them on every forward).  Buffers keep their dtype: BatchNorm's
    running statistics stay f32, as ``vit_tpu`` keeps ``batch_stats`` in f32
    whatever the compute dtype."""
    with torch.no_grad():
        for p in module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(dtype)
    return module


def resolve_device(device=None) -> torch.device:
    """The device a module builds on: the card unless the caller asks for
    another.  ``None`` is CUDA, and raises without a CUDA device rather than
    build on the CPU unasked; pass ``device="cpu"`` for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: vit_tpu_torch builds on the card by default; "
            "pass device='cpu' to build on the CPU")
    return torch.device("cuda")
