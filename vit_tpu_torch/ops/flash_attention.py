"""Flash attention: online-softmax attention that saves each query row's
log-sum-exp, and its two-pass backward.

Port of ``vit_tpu/ops/flash_attention.py::flash_attention`` (``_flash_kernel``,
driven by ``_flash_forward``), ``vit_tpu/ops/flash_attention_v2.py::
flash_attention_v2`` (``_kernel``) and ``vit_tpu/ops/flash_backward.py::
flash_backward`` (``_dq_kernel``, ``_dkv_kernel``).  On a CUDA tensor the
forward launches ``vit_flash_attention_fwd`` and the backward
``vit_flash_attention_bwd`` (``vit_tpu_torch/csrc/flash_attention.cu``); on a
CPU tensor both run their plain PyTorch versions,
:func:`flash_attention_forward_reference` and :func:`flash_backward_reference`.

One kernel streams K/V tiles at any n_k, so ``flash_attention_v2`` is the same
op as ``flash_attention``: ``vit_tpu``'s v1/v2 split was whether all of K fits
in a TPU core's VMEM, and its block sizes were VMEM tiles.

Numerics, mirrored by the plain versions: logits ``(q·kᵀ)·scale`` in f32;
the probabilities rounded to the compute dtype for P·V (``vit_tpu`` kept them
in f32) and the f32 row sum divided out after it; ``lse`` in f32.  Backward:
``D = rowsum(dO∘O)`` in f32 over the stored output; ``p = exp(s - lse)``;
``ds = p·(dp - D)·scale``; ``T(p)`` for dv and ``T(ds)`` for dq and dk, each
rounded; dq, dk and dv accumulated in f32 and rounded once.  In f32 the plain
versions are exact attention and its gradient.

Layout: q ``(b, h, n_q, dk)``, k ``(b, h, n_k, dk)`` and v ``(b, h, n_k,
dv)``, read through their strides (the last axis contiguous, the others
multiples of 16 bytes, the data 16-byte aligned: what the kernels' TMA
tensor maps take, :func:`_tma_problem`), so a view of a channels-last
``(b, n, h·d)`` map goes in as it lies.
The kernels write out, dq, dk and dv token-major: the ``(b, h, n, d)``
tensors they return are views of ``(b, n, h, d)`` memory, which a ``(b, n,
h·d)`` consumer reads without a copy.  q/k and v may have different head
widths where a kernel instance exists (``SUPPORTED_WIDTHS``: ScalableViT's
SSA has q/k 40 and v 32 wide; a width of 40 is zero-filled to 64 in shared
memory by the tensor maps, never in device memory).  At (192, 192) the
backward's dk and dv are two launches of the dk/dv kernel, each recomputing
the softmax (their accumulators together would not fit a thread's
registers).
"""

from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import KERNEL_DTYPES, launch_stream, needs_grad

# (dk, dv) pairs with a kernel instance (csrc/flash_attention.cu); (192, 192)
# takes T2T-ViT's first token transformer, one head of 147 padded to 192 by
# ops/attention.py::_flash as vit_tpu pads it.
SUPPORTED_WIDTHS = ((32, 32), (40, 32), (64, 64), (96, 96), (128, 128), (192, 192))
# The plain versions take the (batch, head) pairs in groups whose f32
# (n_q, n_k) score maps hold at most this many elements (1 GiB), so that they
# run at the shapes the kernels serve.
_PLAIN_MAP_ELEMENTS = 2 ** 28


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def _head_groups(*tensors):
    """The tensors' (b, h) pairs in groups, each ``(pairs, n, d)``."""
    b, h = tensors[0].shape[:2]
    n_q, n_k = tensors[0].shape[2], tensors[1].shape[2]
    flat = [t.reshape(b * h, *t.shape[2:]) for t in tensors]
    step = max(1, _PLAIN_MAP_ELEMENTS // max(1, n_q * n_k))
    for i in range(0, b * h, step):
        yield [t[i:i + step] for t in flat]


def flash_attention_forward_reference(q, k, v, scale: float | None = None):
    """Plain PyTorch version of the forward kernel: ``(out, lse)``, ``out``
    in q's dtype ``(b, h, n_q, dv)``, ``lse`` f32 ``(b, h, n_q)``, with the
    kernel's rounding points (P rounded to q's dtype before P·V)."""
    scale = _scale(q, scale)
    dt = q.dtype
    b, h, n_q = q.shape[:3]
    d = v.shape[-1]
    outs, lses = [], []
    for qc, kc, vc in _head_groups(q, k, v):
        s = (qc.float() @ kc.float().transpose(-1, -2)) * scale
        m = s.amax(-1, keepdim=True)
        e = torch.exp(s - m)
        l = e.sum(-1, keepdim=True)
        outs.append(((e.to(dt).float() @ vc.float()) / l).to(dt))
        lses.append((m + torch.log(l)).squeeze(-1))
    return torch.cat(outs).reshape(b, h, n_q, d), torch.cat(lses).reshape(b, h, n_q)


def flash_backward_reference(q, k, v, o, lse, do, scale: float, exact_dsum: bool = False):
    """Plain PyTorch version of the backward kernels
    (``vit_tpu/ops/flash_backward.py:122-199``), step by step with their
    rounding points: ``(dq, dk, dv)`` in q's dtype, from the forward's ``o``
    and ``lse`` and the output gradient ``do``.  ``exact_dsum`` is the
    cross-attention block's ``cross_bwd``, as the TPU's ``_bwd_kernel``
    computes it: p recomputed as the softmax of its whole row (one key: p =
    1 exactly) and the softmax's dsum = Σ p·dp, where the flash kernels take
    p from the forward's lse and D = rowsum(dO∘O) from the stored output; in
    f32 the two agree."""
    dt = q.dtype
    grads = ([], [], [])
    for qc, kc, vc, oc, lc, dc in _head_groups(q, k, v, o, lse[..., None], do):
        qf, kf, vf, dof = qc.float(), kc.float(), vc.float(), dc.float()
        s = (qf @ kf.transpose(-1, -2)) * scale
        p = torch.softmax(s, dim=-1) if exact_dsum else torch.exp(s - lc)
        dp = dof @ vf.transpose(-1, -2)
        dsum = (p * dp if exact_dsum else dof * oc.float()).sum(-1, keepdim=True)
        ds = (p * (dp - dsum) * scale).to(dt).float()
        grads[0].append((ds @ kf).to(dt))
        grads[1].append((ds.transpose(-1, -2) @ qf).to(dt))
        grads[2].append((p.to(dt).float().transpose(-1, -2) @ dof).to(dt))
    return tuple(torch.cat(g).reshape(t.shape) for g, t in zip(grads, (q, k, v)))


# A TMA tensor map's limits (cuTensorMapEncodeTiled): byte strides that are
# multiples of 16 below 2**40, extents of at most 2**32, 16-byte aligned data.
_TMA_STRIDE_LIMIT = 2 ** 40
_TMA_EXTENT_LIMIT = 2 ** 32


def _tma_problem(t):
    """Why no TMA tensor map takes the 16-bit ``(b, h, n, d)`` operand ``t``
    (``csrc/hopper.cuh``'s ``head_map`` over its :func:`kernel_strides`), or
    None."""
    if t.stride(-1) != 1:
        return "its last axis is not contiguous"
    if t.data_ptr() % 16:
        return "its data is not 16-byte aligned"
    for s, n in zip(t.stride()[:-1], t.shape[:-1]):
        nbytes = s * t.element_size()
        if n > 1 and (nbytes % 16 or not 0 < nbytes < _TMA_STRIDE_LIMIT):
            return f"a stride of {nbytes} bytes is not a positive multiple of 16 below 2**40"
    if any(n > _TMA_EXTENT_LIMIT for n in t.shape):
        return "an extent is above 2**32"
    return None


def _strides_ok(t) -> bool:
    """Whether the kernels take ``t``'s layout (:func:`_tma_problem`)."""
    return _tma_problem(t) is None


def kernel_strides(*tensors):
    """The (batch, head, row) element strides of each tensor, flat, for the
    kernels.  A size-1 axis's stride, which addresses nothing, goes as 8
    elements, a stride every tensor map takes."""
    flat = []
    for t in tensors:  # a plain loop: the launchers call this on every launch
        st, sh = t.stride(), t.shape
        flat += (st[0] if sh[0] > 1 else 8, st[1] if sh[1] > 1 else 8, st[2] if sh[2] > 1 else 8)
    return (ctypes.c_longlong * len(flat))(*flat)


def check_flash_tensors(name: str, tensors: dict, widths=SUPPORTED_WIDTHS) -> None:
    """``{label: (tensor, shape)}``, q first and v third: 16-bit CUDA tensors
    of one device and dtype and of the given shapes, head widths ``(dk, dv)``
    with a kernel instance (in ``widths``), and strides the kernels take
    (:func:`_tma_problem`).  Anything else raises."""
    (q, _), _, (v, _) = list(tensors.values())[:3]
    if q.device.type != "cuda":
        raise ValueError(f"{name}: expected a CPU or CUDA tensor, got {q.device}")
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes bfloat16 or float16, got {q.dtype}")
    if (q.shape[-1], v.shape[-1]) not in widths:
        raise ValueError(f"{name}: head widths (dk, dv) = {(q.shape[-1], v.shape[-1])} have no "
                         f"kernel instance ({widths})")
    for label, (t, shape) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name}: {label} is {t.dtype} on {t.device}, "
                            f"expected {q.dtype} on {q.device}")
        problem = _tma_problem(t)
        if problem:
            raise ValueError(f"{name}: {label} has strides {t.stride()}, which the kernel "
                             f"does not take: {problem}")


def _token_major(b, h, n, d, like):
    """An uninitialised ``(b, h, n, d)`` view of ``(b, n, h, d)`` memory."""
    return torch.empty((b, n, h, d), dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def _launch_forward(name, q, k, v, scale):
    """``vit_flash_attention_fwd`` on CUDA tensors: ``(out, lse)`` as
    :func:`flash_attention_forward_reference` returns them, or raises
    (:func:`check_flash_tensors`).  The caller counts the launch."""
    b, h, n_q, dk = q.shape
    n_k, dv = k.shape[2], v.shape[-1]
    check_flash_tensors(name, {"q": (q, q.shape), "k": (k, (b, h, n_k, dk)),
                               "v": (v, (b, h, n_k, dv))})
    out = _token_major(b, h, n_q, dv, q)
    lse = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.vit_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            kernel_strides(q, k, v, out), b, h, n_q, n_k, dk, dv, float(scale),
            _build.DTYPE_CODES[q.dtype], launch_stream(q))
    _build.check(err, "vit_flash_attention_fwd")
    return out, lse


def flash_attention_forward(q, k, v, scale: float | None = None, counter=None):
    """The forward kernel, ``vit_tpu``'s ``_flash_forward``: ``(out, lse)``
    as :func:`flash_attention_forward_reference` returns them.  A CPU tensor
    takes the plain version; a CUDA tensor launches ``vit_flash_attention_fwd``
    or raises (:func:`check_flash_tensors`).  ``counter.launches`` counts
    kernel launches: ``flash_attention``'s by default, the packed op's
    (:mod:`vit_tpu_torch.ops.flash_attention_packed`) for its calls."""
    scale = _scale(q, scale)
    if q.device.type == "cpu":
        return flash_attention_forward_reference(q, k, v, scale)
    counter = counter or flash_attention
    out = _launch_forward(counter.__name__, q, k, v, scale)
    counter.launches += 1
    return out


def flash_backward(q, k, v, o, lse, do, scale: float):
    """The backward kernels, ``vit_tpu``'s ``flash_backward``: ``(dq, dk,
    dv)`` in q's dtype, as :func:`flash_backward_reference` returns them.  A
    CPU tensor takes the plain version; a CUDA tensor launches
    ``vit_flash_attention_bwd`` (D, then dq, then dk and dv; the same bits
    every run) or raises.  ``flash_backward.launches`` counts kernel
    launches."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, o, lse, do, scale)
    b, h, n_q, dk = q.shape
    n_k, dv = k.shape[2], v.shape[-1]
    check_flash_tensors("flash_backward", {
        "q": (q, q.shape), "k": (k, (b, h, n_k, dk)), "v": (v, (b, h, n_k, dv)),
        "o": (o, (b, h, n_q, dv)), "do": (do, (b, h, n_q, dv))})
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, n_q) \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash_backward: lse must be a contiguous f32 ({b}, {h}, {n_q}) "
                         f"tensor on {q.device}, got {tuple(lse.shape)} {lse.dtype}")
    dq, dk_, dv_ = _token_major(b, h, n_q, dk, q), _token_major(b, h, n_k, dk, q), \
        _token_major(b, h, n_k, dv, q)
    dsum = torch.empty((b, h, n_q), dtype=torch.float32, device=q.device)
    lib = _build.load()
    with torch.cuda.device(q.device):
        err = lib.vit_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk_.data_ptr(), dv_.data_ptr(), dsum.data_ptr(),
            kernel_strides(q, k, v, o, do, dq, dk_, dv_), b, h, n_q, n_k, dk, dv, float(scale),
            _build.DTYPE_CODES[q.dtype], launch_stream(q))
    _build.check(err, "vit_flash_attention_bwd")
    flash_backward.launches += 1
    return dq, dk_, dv_


flash_backward.launches = 0


def kernel_layout(t):
    """``t`` as it lies if the kernels take its strides, else a contiguous
    copy (an incoming gradient may be expanded or transposed)."""
    return t if _strides_ok(t) else t.contiguous()


class FlashAttentionFunction(torch.autograd.Function):
    """The op under autograd (``vit_tpu``'s ``_fwd`` / ``_bwd``): the forward
    keeps ``(q, k, v, out, lse)``, the backward runs :func:`flash_backward`
    on them.  ``counter`` is the op whose ``launches`` the forward counts
    (:func:`flash_attention_forward`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, counter=None):
        out, lse = flash_attention_forward(q, k, v, scale, counter)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, kernel_layout(dout), ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, scale: float | None = None):
    """``softmax(q·kᵀ·scale)·v`` over ``(b, h, n_q, dk)`` q, ``(b, h, n_k,
    dk)`` k and ``(b, h, n_k, dv)`` v, any n_q and n_k, in q's dtype;
    ``scale`` defaults to ``dk ** -0.5``.  Differentiable through
    :class:`FlashAttentionFunction`.  On CUDA it takes bf16 or f16, ``(dk,
    dv)`` ∈ ``SUPPORTED_WIDTHS`` and the strides of
    :func:`check_flash_tensors`, and raises on anything else; on the CPU it
    runs the plain versions.  ``flash_attention.launches`` counts forward
    kernel launches.  Without autograd it is :func:`flash_attention_op`."""
    scale = _scale(q, scale)
    if needs_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, scale, flash_attention)
    return flash_attention_op(q, k, v, float(scale))


flash_attention.launches = 0


@torch.library.custom_op("vit_tpu_torch::flash_attention", mutates_args=(),
                         device_types=("cuda", "cpu"))
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """The serving forward as a registered op, which ``torch.export`` keeps
    as one node: the out of :func:`flash_attention_forward` (on CUDA the
    kernel, counted on ``flash_attention.launches``, its output token-major;
    on the CPU the plain version, contiguous)."""
    return flash_attention_forward(q, k, v, scale)[0]


@flash_attention_op.register_fake
def _(q, k, v, scale):
    b, h, n_q = q.shape[:3]
    if q.device.type == "cpu":
        return q.new_empty((b, h, n_q, v.shape[-1]))
    return _token_major(b, h, n_q, v.shape[-1], q)

# vit_tpu's K/V-streaming tier (n_k > 4096) is the same kernel here: the
# forward streams K/V tiles at any n_k.  One op, one launch counter.
flash_attention_v2 = flash_attention
