"""Scaled-dot-product attention, the path without kernels (port of
``vit_tpu/ops/attention.py``).

Tensors are ``(batch, heads, seq, dim_head)``.  Logits are always formed in
f32.  For f32 models the softmax runs in f32; for bf16 models it keeps
``vit_tpu``'s storage policy (:func:`softmax_lastdim`).  The flash kernels of
``vit_tpu`` are not ported yet, so ``use_flash="force"`` raises; ``"auto"``
and ``"never"`` both take :func:`plain_attention`.
"""

from __future__ import annotations

import torch


def mask_value(dtype: torch.dtype) -> float:
    """Large negative masking value: ``-finfo.max`` of ``dtype`` promoted to
    at least f32 (reference ats_vit.py:97)."""
    return -torch.finfo(torch.promote_types(dtype, torch.float32)).max


def softmax_lastdim(logits: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Softmax over the last axis with ``vit_tpu``'s storage policy.

    bf16 output: the logits are stored bf16, exp runs in f32 and is stored
    bf16, the denominator sums in f32 and only its reciprocal is rounded
    back.  Other dtypes take the exact f32 softmax.
    """
    if out_dtype == torch.bfloat16:
        logits = logits.to(torch.bfloat16)
        m = logits.amax(-1, keepdim=True)
        e = torch.exp((logits - m).float()).to(torch.bfloat16)
        den = e.float().sum(-1, keepdim=True)
        return e * (1.0 / den).to(torch.bfloat16)
    return torch.softmax(logits.float(), dim=-1).to(out_dtype)


def _logits(q, k, scale, bias, mask):
    logits = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        logits = logits + bias.float()
    if mask is not None:
        logits = logits.masked_fill(~mask, mask_value(logits.dtype))
    return logits


def plain_attention(q, k, v, *, scale: float, bias=None, mask=None) -> torch.Tensor:
    """``softmax(q·kᵀ·scale + bias)·v`` with f32 logits and accumulation
    (``vit_tpu/ops/attention.py::_xla_attention``)."""
    out_dtype = q.dtype
    attn = softmax_lastdim(_logits(q, k, scale, bias, mask), out_dtype)
    return (attn.float() @ v.float()).to(out_dtype)


def attention_weights(q, k, *, scale: float | None = None, bias=None,
                      mask=None) -> torch.Tensor:
    """Materialized post-softmax attention matrix (f32), for variants that
    transform it (DeepViT re-attention, CaiT talking-heads, ATS scoring)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return torch.softmax(_logits(q, k, scale, bias, mask), dim=-1)


def apply_attention(attn: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attn @ v`` for a materialized attention matrix, f32 accumulation."""
    return (attn.to(v.dtype).float() @ v.float()).to(v.dtype)


def scaled_dot_product_attention(q, k, v, *, scale: float | None = None,
                                 bias=None, mask=None,
                                 use_flash: str = "auto") -> torch.Tensor:
    """Attention over ``(b, h, n_q, d)`` / ``(b, h, n_k, d)`` tensors.

    ``bias`` is an additive logits bias broadcastable to ``(b, h, n_q, n_k)``;
    ``mask`` is boolean, False positions get :func:`mask_value`.
    ``use_flash``: ``"auto"`` | ``"never"`` run the plain path; ``"force"``
    raises until the flash kernels are ported.
    """
    if use_flash == "force":
        raise NotImplementedError(
            "use_flash='force': the flash-attention kernels are not ported to "
            "CUDA yet (vit_tpu/ops/flash_attention*.py)")
    if use_flash not in ("auto", "never"):
        raise ValueError(f"use_flash must be 'auto', 'never' or 'force', got {use_flash!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return plain_attention(q, k, v, scale=scale, bias=bias, mask=mask)
