"""Plain math shared by the two block ops (``fused_mlp``,
``fused_attention_block``): the LayerNorm statistics, the LayerNorm backward
of the TPU backward kernels, and the weight-gradient GEMM."""

from __future__ import annotations

import torch


def ln_stats(x32: torch.Tensor, eps: float):
    """Mean and rstd over the last axis: biased two-pass variance, eps inside
    the rsqrt (Keras parity, ``vit_tpu/ops/fused_mlp.py::_ln_stats``)."""
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    return mu, torch.rsqrt(var + eps)


def ln_backward_reference(x32, dxn32, gamma32, eps: float):
    """LayerNorm backward of the TPU kernels (``fused_mlp.py:213-227``,
    ``fused_attention_block.py:245-257``) over ``(rows, d)`` f32 rows, with
    ``dxn32`` the gradient at the LayerNorm's output: returns the f32
    ``rstd·(dxhat - mean(dxhat) - xhat·mean(dxhat·xhat))`` and the column sums
    ``Σ dxn·xhat`` (dγ) and ``Σ dxn`` (dβ)."""
    mu, rstd = ln_stats(x32, eps)
    xhat = (x32 - mu) * rstd
    dxhat = dxn32 * gamma32
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx_ln = rstd * (dxhat - m1 - xhat * m2)
    return dx_ln, (dxn32 * xhat).sum(0), dxn32.sum(0)


def weight_grad(g: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``gᵀ·a`` over every leading axis, the gradient of an ``nn.Linear``
    weight whose input was ``a`` and output gradient ``g``: a plain GEMM with
    f32 accumulation, in the inputs' dtype (the dW GEMMs that JAX left to XLA
    outside the Pallas kernels)."""
    return g.reshape(-1, g.shape[-1]).t() @ a.reshape(-1, a.shape[-1])
