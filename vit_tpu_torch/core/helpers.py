"""Shared config helpers (port of ``vit_tpu/core/helpers.py``)."""

from __future__ import annotations

import torch
from torch import nn


def pair(t):
    """Broadcast a scalar to an (h, w) tuple (reference vit.py:11-12)."""
    return t if isinstance(t, tuple) else (t, t)


def exists(val) -> bool:
    return val is not None


def default(val, d):
    return val if exists(val) else d


def divisible_by(numer: int, denom: int) -> bool:
    return (numer % denom) == 0


def cast_params(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the floating-point parameters and buffers of ``module`` to
    ``dtype`` once, in place, and return it (serving: keep bf16 weights
    resident instead of converting them on every forward).  Non-float
    tensors are left as they are (``nn.Module.to`` casts only floats)."""
    return module.to(dtype)
