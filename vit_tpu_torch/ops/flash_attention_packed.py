"""Flash attention over the channel-packed ``(b, n, heads·d)`` layout.

Port of ``vit_tpu/ops/flash_attention_packed.py::flash_attention_packed``
(``_packed_kernel``, driven by ``_packed_forward``, and its custom VJP).
ScalableViT's IWSA makes q, k and v with 1x1 convolutions, so they arrive
channel-packed: ``(b, n, heads·d)``.  The TPU kernel avoided the head-split
and head-merge transposes by unrolling the heads over static lane slices of one
VMEM block.  On the H100 the flash kernels of ``csrc/flash_attention.cu``
already read their operands through (batch, head, row) strides and write
token-major, so the packed layout needs only strided views: head ``h`` of a
packed row starts ``h·d`` elements into it.  No layout copy either way.

The op is the head-major op's autograd Function
(:class:`vit_tpu_torch.ops.flash_attention.FlashAttentionFunction`) between a
head split and a head merge, both views.  On a CUDA tensor the forward
launches ``vit_flash_attention_fwd`` and counts
``flash_attention_packed.launches`` (apart from the head-major op's counter);
the backward runs :func:`vit_tpu_torch.ops.flash_attention.flash_backward` on
the same packed strides (counted there), with no head-major transposes, which
``vit_tpu``'s ``_bwd`` pays.  Where q/k and v differ in width, ``vit_tpu``
recomputed the backward through XLA autodiff; here the ``(dk, dv)`` backward
kernels take it (``SUPPORTED_WIDTHS``).  On a CPU tensor both directions run
the plain versions.  ``vit_tpu``'s ``n_k <= 4096`` limit was VMEM's and does
not apply: the kernels stream K/V tiles at any n_k.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops._checks import needs_grad
from vit_tpu_torch.ops.flash_attention import (
    FlashAttentionFunction, flash_attention_forward, flash_attention_forward_reference,
    flash_backward_reference,
)


def split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``(b, n, heads·d)`` → a ``(b, heads, n, d)`` view."""
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(1, 2)


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """``(b, heads, n, d)`` → ``(b, n, heads·d)``: a view of token-major
    memory, as the kernels write it (a copy otherwise)."""
    b, h, n, d = t.shape
    return t.transpose(1, 2).reshape(b, n, h * d)


def _scale(q, heads, scale):
    return (q.shape[-1] // heads) ** -0.5 if scale is None else scale


def flash_attention_packed_forward_reference(q, k, v, heads: int, scale: float | None = None):
    """Plain PyTorch version of the forward kernel: ``(out, lse)`` with
    ``out`` ``(b, n_q, heads·dv)`` in q's dtype and ``lse`` f32 ``(b, heads,
    n_q)``, at the flash kernel's rounding points."""
    out, lse = flash_attention_forward_reference(
        split_heads(q, heads), split_heads(k, heads), split_heads(v, heads),
        _scale(q, heads, scale))
    return merge_heads(out), lse


def flash_attention_packed_backward_reference(q, k, v, out, lse, dout, heads: int,
                                              scale: float | None = None,
                                              exact_dsum: bool = False):
    """Plain PyTorch version of the backward kernels over packed tensors:
    ``(dq, dk, dv)`` shaped as q, k, v (``exact_dsum`` as
    :func:`~vit_tpu_torch.ops.flash_attention.flash_backward_reference`)."""
    grads = flash_backward_reference(*(split_heads(t, heads) for t in (q, k, v, out)), lse,
                                     split_heads(dout, heads), _scale(q, heads, scale),
                                     exact_dsum)
    return tuple(merge_heads(g) for g in grads)


def flash_attention_packed_forward(q, k, v, heads: int, scale: float | None = None):
    """The forward kernel: ``(out, lse)`` as
    :func:`flash_attention_packed_forward_reference` returns them.  A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``vit_flash_attention_fwd`` on strided views of the packed tensors, or
    raises.  ``flash_attention_packed.launches`` counts the launches."""
    out, lse = flash_attention_forward(
        split_heads(q, heads), split_heads(k, heads), split_heads(v, heads),
        _scale(q, heads, scale), flash_attention_packed)
    return merge_heads(out), lse


def flash_attention_packed(q, k, v, heads: int, scale: float | None = None):
    """``softmax(q·kᵀ·scale)·v`` per head over channel-packed q ``(b, n_q,
    heads·dk)``, k ``(b, n_k, heads·dk)`` and v ``(b, n_k, heads·dv)``;
    returns ``(b, n_q, heads·dv)`` in q's dtype.  ``scale`` defaults to
    ``dk ** -0.5``.  Differentiable; on CUDA it takes ``(dk, dv)`` ∈
    ``SUPPORTED_WIDTHS`` in bf16 or f16 and raises on anything else.
    ``flash_attention_packed.launches`` counts forward kernel launches."""
    if q.shape[-1] % heads or v.shape[-1] % heads:
        raise ValueError(f"flash_attention_packed: widths {q.shape[-1]} and {v.shape[-1]} do "
                         f"not split into {heads} heads")
    scale = _scale(q, heads, scale)
    if not needs_grad(q, k, v):
        return flash_attention_packed_op(q, k, v, heads, float(scale))
    return merge_heads(FlashAttentionFunction.apply(
        split_heads(q, heads), split_heads(k, heads), split_heads(v, heads), scale,
        flash_attention_packed))


flash_attention_packed.launches = 0


@torch.library.custom_op("vit_tpu_torch::flash_attention_packed", mutates_args=(),
                         device_types=("cuda", "cpu"))
def flash_attention_packed_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                              scale: float) -> torch.Tensor:
    """The serving forward as a registered op, which ``torch.export`` keeps
    as one node: the out of :func:`flash_attention_packed_forward` (on CUDA
    the kernel, counted), contiguous ``(b, n_q, heads·dv)``."""
    return flash_attention_packed_forward(q, k, v, heads, scale)[0]


@flash_attention_packed_op.register_fake
def _(q, k, v, heads, scale):
    return q.new_empty(q.shape[:-1] + v.shape[-1:])
