"""Plain math shared by the two block ops (``fused_mlp``,
``fused_attention_block``) and the hybrid layer: the LayerNorm statistics, the
LayerNorm backward of the TPU backward kernels, the weight-gradient GEMM, and
the widths at which the LayerNorm backward is the dgrad's epilogue."""

from __future__ import annotations

import torch

# csrc/gemm_wgmma.cu's kEpiLnBwd: the LayerNorm backward as the epilogue of
# the dgrad into it, on a cluster of d / LN_BWD_TILE CTAs (kLnBwdMinD,
# kLnBwdMaxD: at most 8 CTAs, the portable cluster size).
LN_BWD_TILE, LN_BWD_MIN_D, LN_BWD_MAX_D = 256, 256, 2048


def ln_bwd_fused(d: int) -> bool:
    """Whether the blocks' backwards take the LayerNorm-backward dgrad at
    width ``d`` (``csrc/gemm_wgmma.cu``'s ``ln_bwd_fused``, which C chooses
    by): no f32 dxn and no row statistics reach device memory.  Elsewhere the
    dgrad writes dxn in f32 and ``layernorm.cu``'s passes read it back."""
    return d % LN_BWD_TILE == 0 and LN_BWD_MIN_D <= d <= LN_BWD_MAX_D


def ln_bwd_scratch(rows: int, d: int, device):
    """``(dxn, stats)``: the f32 ``(rows, d)`` dgrad output and ``(rows, 2)``
    row statistics a LayerNorm backward of its own passes needs, or ``(None,
    None)`` where :func:`ln_bwd_fused` holds."""
    if ln_bwd_fused(d):
        return None, None
    f32 = dict(dtype=torch.float32, device=device)
    return torch.empty((rows, d), **f32), torch.empty((rows, 2), **f32)


def data_ptr(t):
    """``t.data_ptr()``, or None (a null pointer to C) for an absent tensor."""
    return None if t is None else t.data_ptr()


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
