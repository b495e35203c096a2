"""Scaled-dot-product attention: the plain path and the flash tiers (port of
``vit_tpu/ops/attention.py``).

Tensors are ``(batch, heads, seq, dim_head)``.  Logits are always formed in
f32.  For f32 models the softmax runs in f32; for bf16 models it keeps
``vit_tpu``'s storage policy (:func:`softmax_lastdim`).

Flash tiers (``vit_tpu/ops/attention.py:61-158``): with ``use_flash="auto"``
a call without a bias or mask, whose q and v share one head width, goes to
the flash kernels (:mod:`vit_tpu_torch.ops.flash_attention`) when
``max(n_q, n_k) >= FLASH_MIN_SEQ`` and q is a 16-bit CUDA tensor.  Every
other call runs :func:`plain_attention`.  The gate is ``vit_tpu``'s 16-bit
tier, which it measured on a TPU v5e; the H100's crossover is in
``PERF.md``.  The port's own rule: ``vit_tpu`` also sends f32 at n >= 2048
to flash, but the port's kernels take 16-bit operands only, so f32 runs the
plain path, on the card too.  There is no fallback: a 16-bit CUDA call at the
tier that the kernel refuses (a head width, a stride) raises.  Head widths
without a kernel instance that are not a multiple of 32 are zero-padded, q, k
and v to one width, a multiple of 64, and the output sliced back (exact: the
pad adds 0 to every logit and to no output column that is kept).  ``"force"``
runs the flash op on any call without a bias or mask and raises
``ValueError`` on one; ``"never"`` runs the plain path.

:func:`packed_window_attention` is the same tiering over channel-packed
``(b, n, heads·d)`` q/k/v (``vit_tpu/ops/attention.py:161-201``): at the tier
it runs the packed op (:mod:`vit_tpu_torch.ops.flash_attention_packed`), which
needs no head split.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_tpu_torch.ops._checks import KERNEL_DTYPES
from vit_tpu_torch.ops.flash_attention import SUPPORTED_WIDTHS, flash_attention
from vit_tpu_torch.ops.flash_attention_packed import (
    flash_attention_packed, merge_heads, split_heads,
)

# The flash tier's sequence length for 16-bit inputs (vit_tpu's, from a v5e).
FLASH_MIN_SEQ = 1024
USE_FLASH_MODES = ("auto", "never", "force")


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


def flash_tensor(t: torch.Tensor) -> bool:
    """Whether the flash kernels take ``t``'s kind: a 16-bit CUDA tensor."""
    return t.is_cuda and t.dtype in KERNEL_DTYPES


def _use_flash(q, k, v, bias, mask) -> bool:
    """``vit_tpu``'s ``_use_flash`` with the port's rule for f32: no bias or
    mask, one head width for q and v, a 16-bit CUDA q, and
    ``max(n_q, n_k) >= FLASH_MIN_SEQ``."""
    if bias is not None or mask is not None or q.shape[-1] != v.shape[-1]:
        return False
    return flash_tensor(q) and max(q.shape[2], k.shape[2]) >= FLASH_MIN_SEQ


def _flash(q, k, v, scale):
    """The flash op.  Head widths ``(dk, dv)`` without a kernel instance go
    in zero-padded to one width: the larger of the two, rounded up to a
    multiple of 64 unless it is a multiple of 32 (``vit_tpu/ops/
    attention.py:141-145``); the output is sliced back to dv."""
    dk, dv = q.shape[-1], v.shape[-1]
    if (dk, dv) not in SUPPORTED_WIDTHS:
        d = max(dk, dv)
        d += 0 if d % 32 == 0 else (-d) % 64
        q, k, v = (t if t.shape[-1] == d else F.pad(t, (0, d - t.shape[-1])) for t in (q, k, v))
    out = flash_attention(q, k, v, scale)
    return out if out.shape[-1] == dv else out[..., :dv]


def scaled_dot_product_attention(q, k, v, *, scale: float | None = None,
                                 bias=None, mask=None,
                                 use_flash: str = "auto") -> torch.Tensor:
    """Attention over ``(b, h, n_q, d)`` / ``(b, h, n_k, d)`` tensors.

    ``bias`` is an additive logits bias broadcastable to ``(b, h, n_q, n_k)``;
    ``mask`` is boolean, False positions get :func:`mask_value`.
    ``use_flash``: ``"auto"`` takes the flash tiers of the module docstring,
    ``"never"`` the plain path, ``"force"`` the flash op (``ValueError`` with
    a bias or mask).
    """
    if use_flash not in USE_FLASH_MODES:
        raise ValueError(f"use_flash must be one of {USE_FLASH_MODES}, got {use_flash!r}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if use_flash == "force":
        if bias is not None or mask is not None:
            raise ValueError("use_flash='force' cannot carry a bias or mask: the flash "
                             "kernels take neither")
        return _flash(q, k, v, scale)
    if use_flash == "auto" and _use_flash(q, k, v, bias, mask):
        return _flash(q, k, v, scale)
    return plain_attention(q, k, v, scale=scale, bias=bias, mask=mask)


def packed_window_attention(q, k, v, heads: int, *, scale: float | None = None,
                            mode: str = "auto") -> torch.Tensor:
    """Attention over channel-packed q ``(b, n_q, heads·dk)``, k ``(b, n_k,
    heads·dk)`` and v ``(b, n_k, heads·dv)``; returns ``(b, n_q,
    heads·dv)``.  ``scale`` defaults to ``dk ** -0.5``.

    ``mode``: ``"auto"`` takes :func:`_use_flash`'s tier, a 16-bit CUDA q at
    ``max(n_q, n_k) >= FLASH_MIN_SEQ``, where it runs the packed op if it
    has an instance for ``(dk, dv)``, and else splits the heads and runs
    :func:`_flash` (padded; counted by ``flash_attention.launches``); below
    the tier it runs :func:`scaled_dot_product_attention` on the head-major
    views.  ``"force"`` takes the flash routes at any length and kind (CUDA
    raises on what the kernels refuse); ``"never"`` the plain path.
    ``vit_tpu``'s ``n_k <= 4096`` cap on the packed kernel was VMEM's and is
    dropped; its ``"interpret"`` mode ran the Pallas interpreter and raises.
    """
    if mode == "interpret":
        raise ValueError("mode='interpret' is a TPU-only mode: it ran the Pallas kernels in "
                         "the TPU interpreter for CPU tests (the port's CPU path is the "
                         "kernels' plain PyTorch versions)")
    if mode not in USE_FLASH_MODES:
        raise ValueError(f"mode must be one of {USE_FLASH_MODES}, got {mode!r}")
    if q.shape[-1] % heads or v.shape[-1] % heads:
        raise ValueError(f"packed_window_attention: widths {q.shape[-1]} and {v.shape[-1]} do "
                         f"not split into {heads} heads")
    dk, dv = q.shape[-1] // heads, v.shape[-1] // heads
    if scale is None:
        scale = dk ** -0.5
    if mode == "force" or (mode == "auto" and flash_tensor(q)
                           and max(q.shape[1], k.shape[1]) >= FLASH_MIN_SEQ):
        if (dk, dv) in SUPPORTED_WIDTHS:
            return flash_attention_packed(q, k, v, heads, scale)
        return merge_heads(_flash(*(split_heads(t, heads) for t in (q, k, v)), scale))
    out = scaled_dot_product_attention(*(split_heads(t, heads) for t in (q, k, v)), scale=scale,
                                       use_flash="never" if mode == "never" else "auto")
    return merge_heads(out)
