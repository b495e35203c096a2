"""Short-sequence attention: an exact-softmax forward over whole rows of at
most ``MAX_SEQ`` keys, and a one-pass backward.

Port of ``vit_tpu/ops/short_attention.py::short_attention`` (``_fwd_kernel``
driven by ``_forward``, ``_bwd_kernel`` by ``_backward``, and its custom VJP),
whose kernels are also the attention of the hybrid layer
(``vit_tpu/ops/fused_hybrid.py::attention_nb``,
:mod:`vit_tpu_torch.ops.fused_hybrid`): one function in two layouts.  On a
CUDA tensor the forward launches ``vit_short_attention_fwd`` and the backward
``vit_short_attention_bwd`` (``vit_tpu_torch/csrc/short_attention.cu``); on a
CPU tensor both run their plain PyTorch versions,
:func:`short_attention_forward_reference` and
:func:`short_attention_backward_reference`.

Explicit use only, as in ``vit_tpu`` (``vit_tpu/ops/attention.py:52-58``): the
dispatcher of :mod:`vit_tpu_torch.ops.attention` never sends a call here.

Numerics, mirrored by the plain versions: logits ``(q·kᵀ)·scale`` in f32; the
softmax exact over the whole row, from the row's own maximum, its sum in f32;
``p = exp(s - m) / l`` rounded to the operand dtype for p·v (as
``attention_nb`` rounds, ``fused_hybrid.py:337``); ``lse = m + log l`` in f32
for the backward.  Backward: ``D = rowsum(dO∘O)`` over the stored output,
``p = exp(s - lse)``, ``ds = p·(dp - D)·scale``; ``T(p)`` for dv and ``T(ds)``
for dq and dk, each rounded, as ``attention_nb``'s backward rounds
(``fused_hybrid.py:369-377``); the gradients accumulated in f32 and rounded
once.  That is the flash backward's function (:func:`
vit_tpu_torch.ops.flash_attention.flash_backward_reference`), which the
kernel computes in one pass instead of two.  In f32 both directions are exact
attention and its gradient, ``vit_tpu``'s function.

Layout: ``(b, h, n, d)`` operands read through their strides (the last axis
contiguous, the others multiples of 8 elements: both kernels read them
through TMA tensor maps), so strided views go in as they lie.  ``layout="bh"``
returns contiguous ``(b, h, n, d)`` outputs;
``layout="nb"`` returns ``(b, h, n, d)`` views of ``(n, b, h, d)`` memory,
and the backward's dq, dk and dv views of one ``(n, b, 3, h, d)`` buffer: the
hybrid layer's ``(n, b, 3·heads·dh)`` q|k|v gradient, with no concatenation.
The kernels take n_q, n_k ≤ 512 and d ∈ ``SUPPORTED_WIDTHS``, in bf16 or f16.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import launch_stream, needs_grad
from vit_tpu_torch.ops.flash_attention import (
    check_flash_tensors, flash_backward_reference, kernel_layout, kernel_strides,
)

MAX_SEQ = 512
SUPPORTED_WIDTHS = (32, 64, 128)


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def short_attention_supported(n_q: int, n_k: int, d: int) -> bool:
    """Whether the kernels take these lengths and head width."""
    return 0 <= n_q <= MAX_SEQ and 1 <= n_k <= MAX_SEQ and d in SUPPORTED_WIDTHS


def short_attention_forward_reference(q, k, v, scale: float | None = None, bias=None):
    """Plain PyTorch version of the forward kernel: ``(out, lse)``, ``out``
    in q's dtype ``(b, h, n_q, d)``, ``lse`` f32 ``(b, h, n_q)``, at the
    rounding points of the kernel instance the arguments select.

    ``bias``: None or an f32 ``(1 | h, n_q, n_k)`` logits bias (the attention
    block's), added to the scaled f32 logits before the row max.  Like the
    kernel's ``BIAS`` flag, it also selects where P is rounded:

    - without a bias, p normalised (``e / l``), then rounded to q's dtype
      for P·V;
    - with one, the unnormalised ``e`` rounded for P·V and the f32 row sum
      divided after: the TPU block kernel's late divide.  The biased kernel's
      one pass rescales by a running max, which moves a rounding by a unit
      where a row's max lies past its first key tile.
    """
    scale = _scale(q, scale)
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    if bias is None:
        out = ((e / l).to(q.dtype).float() @ v.float()).to(q.dtype)
    else:
        out = ((e.to(q.dtype).float() @ v.float()) / l).to(q.dtype)
    return out, (m + torch.log(l)).squeeze(-1)


def short_attention_backward_reference(q, k, v, o, lse, do, scale: float, bias=None,
                                       need_dbias: bool = False):
    """Plain PyTorch version of the backward kernel: ``(dq, dk, dv)`` in q's
    dtype from the forward's ``o`` and ``lse`` and the output gradient
    ``do``; without a bias the flash backward's function and rounding points
    (:func:`flash_backward_reference`).  With an f32 ``(1 | h, n_q, n_k)``
    ``bias`` (the attention block's), ``p = exp(s·scale + bias - lse)``, and
    with ``need_dbias`` a fourth result, ``dbias`` f32 of the bias's shape:
    ``p·(dp - D)`` (before the scale, ``D = rowsum(dO∘O)``) summed over the
    images, and over the heads for a shared bias, as the row statistics the
    kernel writes (lse, D) give it to the dbias kernel."""
    if bias is None:
        return flash_backward_reference(q, k, v, o, lse, do, scale)
    dt = q.dtype
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dsum = (dof * o.float()).sum(-1, keepdim=True)  # D = rowsum(dO∘O)
    p = torch.exp((qf @ kf.transpose(-1, -2)) * scale + bias.float() - lse[..., None])
    ds0 = p * (dof @ vf.transpose(-1, -2) - dsum)  # d(loss)/d(logits), before the scale
    ds = (ds0 * scale).to(dt).float()
    grads = ((ds @ kf).to(dt), (ds.transpose(-1, -2) @ qf).to(dt),
             (p.to(dt).float().transpose(-1, -2) @ dof).to(dt))
    if not need_dbias:
        return grads
    dbias = ds0.sum(0)
    return grads + (dbias.sum(0, keepdim=True) if bias.shape[0] == 1 else dbias,)


def _empty(like, b, h, n, d, layout, count):
    """``count`` uninitialised ``(b, h, n, d)`` tensors as the kernels write
    them for ``layout``: contiguous, or views of one ``(n, b, count, h, d)``
    buffer."""
    if layout == "nb":
        buf = torch.empty((n, b, count, h, d), dtype=like.dtype, device=like.device)
        return [buf[:, :, i].permute(1, 2, 0, 3) for i in range(count)]
    return [torch.empty((b, h, n, d), dtype=like.dtype, device=like.device)
            for _ in range(count)]


def _laid_out(tensors, layout):
    """The plain versions' contiguous results in ``layout``'s memory."""
    b, h, n, d = tensors[0].shape
    if layout == "bh" or any(t.shape[2] != n for t in tensors):
        return tuple(tensors)
    out = _empty(tensors[0], b, h, n, d, layout, len(tensors))
    for dst, src in zip(out, tensors):
        dst.copy_(src)
    return tuple(out)


def _check(name, tensors):
    """The CUDA checks of :func:`check_flash_tensors` with this kernel's
    widths, and its lengths."""
    (q, _), (k, _) = list(tensors.values())[:2]
    if q.is_cuda and not short_attention_supported(q.shape[2], k.shape[2], q.shape[-1]):
        raise ValueError(f"{name}: n_q={q.shape[2]}, n_k={k.shape[2]}, d={q.shape[-1]}; the "
                         f"kernel takes n_q, n_k <= {MAX_SEQ} and d in {SUPPORTED_WIDTHS}")
    check_flash_tensors(name, tensors, widths=tuple((d, d) for d in SUPPORTED_WIDTHS))


def short_attention_forward(q, k, v, scale: float | None = None, *, need_lse: bool = True,
                            layout: str = "bh", counter=None):
    """The forward kernel: ``(out, lse)`` as
    :func:`short_attention_forward_reference` returns them (``lse`` None
    unless ``need_lse``), ``out`` laid out for ``layout``.  A CPU tensor
    takes the plain version; a CUDA tensor launches
    ``vit_short_attention_fwd`` or raises.  ``counter.launches`` counts the
    launches: :func:`short_attention`'s by default."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        out, lse = short_attention_forward_reference(q, k, v, scale)
        return _laid_out((out,), layout)[0], lse if need_lse else None
    counter = counter or short_attention
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    _check(counter.__name__, {"q": (q, q.shape), "k": (k, (b, h, n_k, d)),
                              "v": (v, (b, h, n_k, d))})
    (out,) = _empty(q, b, h, n_q, d, layout, 1)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device) if need_lse else None
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.vit_short_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if need_lse else None, kernel_strides(q, k, v, out), b, h, n_q, n_k,
            d, float(scale), _build.DTYPE_CODES[q.dtype], launch_stream(q))
    _build.check(err, "vit_short_attention_fwd")
    counter.launches += 1
    return out, lse


def short_attention_backward(q, k, v, o, lse, do, scale: float, *, layout: str = "bh",
                             counter=None):
    """The backward kernel: ``(dq, dk, dv)`` as
    :func:`short_attention_backward_reference` returns them, laid out for
    ``layout``.  A CPU tensor takes the plain version; a CUDA tensor launches
    ``vit_short_attention_bwd`` (the same bits every run) or raises.
    ``counter.launches`` counts the launches:
    :func:`short_attention_backward`'s by default."""
    if q.device.type == "cpu":
        return _laid_out(short_attention_backward_reference(q, k, v, o, lse, do, scale), layout)
    counter = counter or short_attention_backward
    b, h, n_q, d = q.shape
    n_k = k.shape[2]
    if layout == "nb" and n_q != n_k:
        raise ValueError(f"{counter.__name__}: the (n, b, ·) layout needs n_q == n_k, got "
                         f"{n_q} and {n_k}")
    _check(counter.__name__, {
        "q": (q, q.shape), "k": (k, (b, h, n_k, d)), "v": (v, (b, h, n_k, d)),
        "o": (o, q.shape), "do": (do, q.shape)})
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, n_q) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"{counter.__name__}: lse must be a contiguous f32 ({b}, {h}, {n_q}) "
                         f"tensor on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    if layout == "nb":
        dq, dk, dv = _empty(q, b, h, n_q, d, layout, 3)
    else:
        (dq,), (dk, dv) = _empty(q, b, h, n_q, d, layout, 1), _empty(q, b, h, n_k, d, layout, 2)
    lib = _build.load()
    parts = lib.vit_short_attention_parts(n_k, d)
    dq_part = torch.empty((parts, b, h, n_q, d), dtype=torch.float32, device=q.device) \
        if parts > 1 else None
    with torch.cuda.device(q.device):
        err = lib.vit_short_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dq_part.data_ptr() if dq_part is not None else None,
            kernel_strides(q, k, v, o, do, dq, dk, dv), b, h, n_q, n_k, d, float(scale),
            _build.DTYPE_CODES[q.dtype], launch_stream(q))
    _build.check(err, "vit_short_attention_bwd")
    counter.launches += 1
    return dq, dk, dv


short_attention_backward.launches = 0


def nb_heads(t, heads: int):
    """``(n, b, heads·dh)`` → a ``(b, heads, n, dh)`` view."""
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).permute(1, 2, 0, 3)


def nb_merge(t):
    """``(b, heads, n, dh)`` → ``(n, b, heads·dh)``: a view of ``(n, b,
    heads, dh)`` memory, as the kernels write it for ``layout="nb"`` (a copy
    otherwise)."""
    b, h, n, d = t.shape
    return t.permute(2, 0, 1, 3).reshape(n, b, h * d)


def short_attention_backward_nb(q, k, v, out, lse, do, heads: int, scale: float, counter):
    """:func:`short_attention_backward` over the ``(n, b, heads·dh)`` rows of
    q, k, v and do, with the forward's ``(b, heads, n, dh)`` out: ``(dq, dk,
    dv)`` ``(n, b, heads·dh)``, views of one ``(n, b, 3·heads·dh)`` buffer.
    Counts ``counter.launches``."""
    grads = short_attention_backward(*(nb_heads(t, heads) for t in (q, k, v)), out, lse,
                                     kernel_layout(nb_heads(do, heads)), scale, layout="nb",
                                     counter=counter)
    return tuple(nb_merge(g) for g in grads)


class ShortAttentionFunction(torch.autograd.Function):
    """The op under autograd (``vit_tpu``'s ``_vjp_fwd`` / ``_vjp_bwd``):
    the forward keeps ``(q, k, v, out, lse)``, the backward runs
    :func:`short_attention_backward` on them.  With ``heads`` None, q, k, v
    and the output are ``(b, h, n, d)``; with ``heads``, they are the
    ``(n, b, heads·dh)`` rows of the hybrid layer, split into heads and
    merged back inside the Function (strided views, no copies, and no view
    of them for autograd to track), and the gradients are views of one
    ``(n, b, 3·heads·dh)`` buffer.  ``counters`` is the pair of ops whose
    ``launches`` the forward and the backward count."""

    @staticmethod
    def forward(ctx, q, k, v, scale, heads, counters):
        rows = (q, k, v) if heads is None else tuple(nb_heads(t, heads) for t in (q, k, v))
        out, lse = short_attention_forward(*rows, scale, layout="bh" if heads is None else "nb",
                                           counter=counters[0])
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.heads, ctx.counter = scale, heads, counters[1]
        return out if heads is None else nb_merge(out)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.heads is None:
            grads = short_attention_backward(q, k, v, out, lse, kernel_layout(dout), ctx.scale,
                                             counter=ctx.counter)
        else:
            grads = short_attention_backward_nb(q, k, v, out, lse, dout, ctx.heads, ctx.scale,
                                                ctx.counter)
        return (*grads, None, None, None)


def short_attention(q, k, v, scale: float | None = None):
    """``softmax(q·kᵀ·scale)·v`` over ``(b, h, n_q, d)`` q and ``(b, h, n_k,
    d)`` k and v, n_q, n_k ≤ ``MAX_SEQ``, in q's dtype; ``scale`` defaults
    to ``d ** -0.5``.  Differentiable.  When autograd records the call it
    goes through :class:`ShortAttentionFunction`; otherwise the serving
    forward keeps no lse.  On CUDA it takes bf16 or f16, d ∈
    ``SUPPORTED_WIDTHS`` and the strides of :func:`check_flash_tensors`, and
    raises on anything else; on the CPU it runs the plain versions.
    ``short_attention.launches`` counts forward kernel launches."""
    scale = _scale(q, scale)
    if needs_grad(q, k, v):
        return ShortAttentionFunction.apply(q, k, v, scale, None,
                                            (short_attention, short_attention_backward))
    return short_attention_forward(q, k, v, scale, need_lse=False)[0]


short_attention.launches = 0
