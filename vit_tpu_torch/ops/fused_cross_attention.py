"""Fused cross-attention block: ``x + out_proj(attn(xn·Wqᵀ, k, v))``, forward
and backward, with k and v precomputed.

Port of ``vit_tpu/ops/fused_cross_attention.py::fused_cross_attention_block``:
the TPU forward kernel ``_fwd_kernel`` (driven by ``_forward``), the backward
kernel ``_bwd_kernel`` (``_backward``) and the custom VJP (``_vjp_fwd`` /
``_vjp_bwd``) as :class:`FusedCrossAttentionFunction`.  ScalableViT's SSA
(and Twins-SVT's global attention) has this shape: queries from a 1x1
convolution (a tokenwise GEMM) of the normalised stream ``xn``, keys and
values from a strided convolution of it, which stays outside.  On a CUDA
tensor the forward launches ``vit_fused_cross_attention_fwd`` and the
backward ``vit_fused_cross_attention_bwd`` (``csrc/fused_cross_attention.cu``:
the forward one ``cross_fwd`` kernel, per head the q GEMM, the softmax and
P·V in registers, then the output GEMM over every head with bias and
residual, at every shape it takes (``dh_k, dh_v`` of ``(32, 32)``, ``(40,
32)`` or ``(64, 64)``, n_k ≤ 128: every ScalableViT SSA), from c = 256
``cross_fwd`` writing oattn and ``gemm_wgmma`` taking the output GEMM, the q
GEMM, the ``(dh_k, dh_v)`` flash kernels and the output GEMM at other shapes;
the backward at the same shapes one ``cross_bwd`` kernel and its fixed-order
reduction up to 128 channels, from 129 ``cross_bwd`` between the doattn and
dxn GEMMs on ``gemm_wgmma``, past 128 keys the doattn and dxn GEMMs, the
flash backward and the fixed-order ``dbo`` sums; the C library gives the
route, :func:`backward_route`); on a CPU tensor both run their plain PyTorch
versions, :func:`fused_cross_attention_forward_reference` and
:func:`fused_cross_attention_backward_reference`.

What bounds it on the H100: at ScalableViT's stage 1 (batch 64, 4096 tokens of
64 channels, 2 heads, 64 keys) the forward does about 9.7 GFLOP against about
101 MB of x, xn and y, so the memory bounds it; at stage 3 (256 tokens of 256
channels, 8 heads) the GEMMs and the bytes are of one size.  The design keeps
the ``(n, n_k)`` scores, q and oattn on chip, reads k and v channel-packed
through their strides (no head split or merge), and fuses the bias and
residual into the output GEMM's epilogue; the training forward writes q,
oattn and lse for the backward, serving none of them.  The backward at stage
1 moves about 188 MB against 17 GFLOP, so bytes bound it too: ``cross_bwd``
keeps doattn, p and ds on chip, reads no oattn, and splits each image's
queries into spans that fill the card, their f32 dk and dv partials summed
in a fixed order.

Numerics, mirrored by the plain versions: ``q = T(xn·Wqᵀ)``; logits in f32;
P rounded to the compute dtype for P·V and the f32 row sum divided out after
it (``vit_tpu``'s late divide, ``:98-104``); oattn rounded; the residual adds
in the compute dtype.  Backward: ``doattn = T(dy·Wo)``; p from the saved
lse, ``dp = doattn·vᵀ`` and the TPU kernel's ``dsum = Σ p·dp`` (``:150``;
the four-step route past 128 keys takes ``D = rowsum(doattn∘oattn)`` from
the stored output instead: equal in f32); ``ds = T(p·(dp - dsum)·scale)``;
dq, dk, dv rounded once; ``dxn = T(dq·Wq)``; ``dbo`` the f32 sum of dy.  In
f32 the plain versions are exact attention and its gradient.

Layouts: x, xn ``(b, n, c)``; k ``(b, n_k, heads·dh_k)``; v ``(b, n_k,
heads·dh_v)``; ``wq`` ``(heads·dh_k, c)`` and ``wo`` ``(c, heads·dh_v)`` in
``nn.Linear`` layout (``vit_tpu`` takes their transposes); ``bo`` ``(c,)``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import check_kernel_tensors, launch_stream, needs_grad
from vit_tpu_torch.ops._shared import weight_grad
from vit_tpu_torch.ops.flash_attention import SUPPORTED_WIDTHS
from vit_tpu_torch.ops.flash_attention_packed import (
    flash_attention_packed_backward_reference, flash_attention_packed_forward_reference,
)


def _scale(dh_k, scale):
    return dh_k ** -0.5 if scale is None else scale


def fused_cross_attention_forward_reference(x, xn, wq, k, v, wo, bo, heads: int, dh_k: int,
                                            dh_v: int, scale: float | None = None):
    """Plain PyTorch version of the training forward, same rounding points as
    the kernels: returns ``(y, q, oattn, lse)``, the residuals the backward
    needs beside xn, k and v."""
    dt = x.dtype
    q = F.linear(xn.float(), wq.float()).to(dt)
    oattn, lse = flash_attention_packed_forward_reference(q, k, v, heads, _scale(dh_k, scale))
    y = F.linear(oattn.float(), wo.float(), bo.float())
    return x + y.to(dt), q, oattn, lse


def fused_cross_attention_reference(x, xn, wq, k, v, wo, bo, heads: int, dh_k: int, dh_v: int,
                                    scale: float | None = None):
    """Plain PyTorch version of the serving forward: ``y`` of
    :func:`fused_cross_attention_forward_reference`."""
    return fused_cross_attention_forward_reference(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v,
                                                   scale)[0]


def fused_cross_attention_backward_reference(dy, q, k, v, oattn, lse, wq, wo, heads: int,
                                             dh_k: int, dh_v: int, scale: float | None = None,
                                             stored_output_d: bool = False):
    """Plain PyTorch version of the backward kernels, step by step with their
    rounding points: ``(dxn, dq, dk, dv, dbo)``, the first four in the
    compute dtype and the shapes of xn, q, k, v, ``dbo`` ``(c,)`` in f32.
    The softmax's dsum = Σ p·dp, as ``cross_bwd`` and the TPU kernel take it;
    ``stored_output_d`` takes D = rowsum(doattn∘oattn) instead, as the
    four-step backward (route 0 of :func:`backward_route`) does."""
    dt = dy.dtype
    c = dy.shape[-1]
    dy32 = dy.reshape(-1, c).float()
    doattn = (dy32 @ wo.float()).to(dt).reshape(oattn.shape)
    dq, dk, dv = flash_attention_packed_backward_reference(q, k, v, oattn, lse, doattn, heads,
                                                           _scale(dh_k, scale),
                                                           exact_dsum=not stored_output_d)
    dxn = (dq.reshape(-1, q.shape[-1]).float() @ wq.float()).to(dt).reshape(dy.shape)
    return dxn, dq, dk, dv, dy32.sum(0)


def fused_cross_attention_supported(c: int, dh_k: int, dh_v: int) -> bool:
    """Whether the kernels take these widths: 16-byte rows and head widths
    with a flash instance."""
    return c % 8 == 0 and (dh_k, dh_v) in SUPPORTED_WIDTHS


def _check(name, x, n_k, heads, dh_k, dh_v, tensors):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (b, n, c), got {tuple(x.shape)}")
    b, n, c = x.shape
    if not fused_cross_attention_supported(c, dh_k, dh_v):
        raise ValueError(f"{name} kernel needs c % 8 == 0 and (dh_k, dh_v) in "
                         f"{SUPPORTED_WIDTHS}, got c={c}, dh_k={dh_k}, dh_v={dh_v}")
    if not (1 <= b <= 65535 and n_k >= 1):
        raise ValueError(f"{name}: the kernel takes 1 <= b <= 65535 images and n_k >= 1, got "
                         f"b={b}, n_k={n_k}")
    check_kernel_tensors(name, x, tensors)


def _launch_forward(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale, training=False):
    """The forward kernels on CUDA tensors: ``(y, q, oattn, lse)``.  The
    training forward keeps q, oattn and lse for the backward.  Serving takes
    what the shape's route (``vit_fused_cross_attention_fused``) needs and
    returns None for the rest: nothing on the one ``cross_fwd`` kernel (1),
    oattn where a GEMM takes y from it (2, c ≥ 256), all three on the
    three-launch forward (0).  ``fused_cross_attention.launches`` counts the
    launches."""
    b, n, c = x.shape
    n_k = k.shape[1]
    hk, hv = heads * dh_k, heads * dh_v
    _check("fused_cross_attention", x, n_k, heads, dh_k, dh_v, {
        "xn": (xn, x.shape), "wq": (wq, (hk, c)), "k": (k, (b, n_k, hk)),
        "v": (v, (b, n_k, hv)), "wo": (wo, (c, hv)), "bo": (bo, (c,))})
    lib = _build.load()
    y = torch.empty_like(x)
    q = oattn = lse = None
    route = lib.vit_fused_cross_attention_fused(b, n, n_k, c, heads, dh_k, dh_v)
    if training or route == 0:
        q = torch.empty((b, n, hk), dtype=x.dtype, device=x.device)
        lse = torch.empty((b, heads, n), dtype=torch.float32, device=x.device)
    if training or route != 1:
        oattn = torch.empty((b, n, hv), dtype=x.dtype, device=x.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = lib.vit_fused_cross_attention_fwd(
            x.data_ptr(), xn.data_ptr(), wq.data_ptr(), k.data_ptr(), v.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), y.data_ptr(), ptr(q), ptr(oattn), ptr(lse), b, n,
            n_k, c, heads, dh_k, dh_v, float(scale), _build.DTYPE_CODES[x.dtype],
            launch_stream(x))
    _build.check(err, "vit_fused_cross_attention_fwd")
    fused_cross_attention.launches += 1
    return y, q, oattn, lse


# The backward's launches by route (backward_route): 1 one cross_bwd kernel, 2
# cross_bwd between two GEMMs, 0 the four steps.
BACKWARD_ROUTES = {route: SimpleNamespace(launches=0) for route in (0, 1, 2)}
# (shape, route asked for, device) -> (route, scratch bytes), from the library.
_BACKWARD_PLANS = {}


def backward_route(b: int, n: int, n_k: int, c: int, heads: int, dh_k: int, dh_v: int,
                   route: int | None = None) -> int:
    """The backward's route at a shape, as the C library decides it
    (``cross_bwd_plan``): 1, one ``cross_bwd`` kernel with the doattn and dxn
    GEMMs inside, and its reduction (up to 128 channels); 2, ``cross_bwd``
    between those two GEMMs on ``gemm_wgmma`` (from 129); 0, the four steps
    (past 128 keys, or head widths ``cross_bwd`` has no instance for).  With
    ``route`` given: that route where the shape can take it (0 always, 2
    wherever 1 or 2 is the shape's), else -1."""
    return _build.load().vit_fused_cross_attention_bwd_route(
        b, n, n_k, c, heads, dh_k, dh_v, -1 if route is None else route)


def fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, heads: int, dh_k: int,
                                   dh_v: int, scale: float | None = None,
                                   route: int | None = None):
    """The backward kernels: what :func:`fused_cross_attention_backward_reference`
    returns (with ``stored_output_d`` on route 0).  A CPU tensor takes the
    plain version; a CUDA tensor launches ``vit_fused_cross_attention_bwd``
    (the same bits every run) on the shape's route, or on ``route`` where
    the card's comparison of designs asks for one (:func:`backward_route`),
    or raises.  ``fused_cross_attention_backward.launches`` counts kernel
    launches and ``BACKWARD_ROUTES[r]`` those on route r."""
    scale = _scale(dh_k, scale)
    if dy.device.type == "cpu":
        return fused_cross_attention_backward_reference(dy, q, k, v, oattn, lse, wq, wo, heads,
                                                        dh_k, dh_v, scale)
    return _launch_backward(dy, q, k, v, oattn, lse, wq, wo, heads, dh_k, dh_v, scale, route)


def _launch_backward(dy, q, k, v, oattn, lse, wq, wo, heads, dh_k, dh_v, scale, route=None):
    """``vit_fused_cross_attention_bwd`` on CUDA tensors, each passed as it
    lies (the kernels read q, k, v, oattn and dy channel-packed through
    their strides, Wq and Wo in nn.Linear layout), with the one scratch
    buffer the library sizes for the route."""
    b, n, c = dy.shape
    n_k = k.shape[1]
    hk, hv = heads * dh_k, heads * dh_v
    _check("fused_cross_attention backward", dy, n_k, heads, dh_k, dh_v, {
        "q": (q, (b, n, hk)), "k": (k, (b, n_k, hk)), "v": (v, (b, n_k, hv)),
        "oattn": (oattn, (b, n, hv)), "wq": (wq, (hk, c)), "wo": (wo, (c, hv))})
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, heads, n) \
            or not lse.is_contiguous() or lse.device != dy.device:
        raise ValueError(f"fused_cross_attention backward: lse must be a contiguous f32 "
                         f"({b}, {heads}, {n}) tensor on {dy.device}, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    dxn, dq, dk, dv = (torch.empty_like(t) for t in (dy, q, k, v))
    dbo = torch.empty(c, dtype=torch.float32, device=dy.device)
    lib = _build.load()
    shape = (b, n, n_k, c, heads, dh_k, dh_v, -1 if route is None else route)
    with torch.cuda.device(dy.device):
        plan = _BACKWARD_PLANS.get((shape, dy.device))
        if plan is None:  # the route, and the scratch bytes the device's SM count sets
            plan = (lib.vit_fused_cross_attention_bwd_route(*shape),
                    lib.vit_fused_cross_attention_bwd_scratch(*shape))
            _BACKWARD_PLANS[(shape, dy.device)] = plan
        taken, nbytes = plan
        if taken < 0:
            raise ValueError(f"fused_cross_attention backward: route {route} does not take "
                             f"{shape[:-1]}")
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=dy.device)
        err = lib.vit_fused_cross_attention_bwd(
            dy.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), oattn.data_ptr(),
            lse.data_ptr(), wq.data_ptr(), wo.data_ptr(), dxn.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dbo.data_ptr(), scratch.data_ptr(), *shape[:-1],
            float(scale), shape[-1], _build.DTYPE_CODES[dy.dtype], launch_stream(dy))
    _build.check(err, "vit_fused_cross_attention_bwd")
    fused_cross_attention_backward.launches += 1
    BACKWARD_ROUTES[taken].launches += 1
    return dxn, dq, dk, dv, dbo


fused_cross_attention_backward.launches = 0


class FusedCrossAttentionFunction(torch.autograd.Function):
    """The op under autograd (``_vjp_fwd`` / ``_vjp_bwd``): the training
    forward keeps ``xn, q, k, v, oattn, lse``; the backward runs the backward
    kernels, then the weight gradients ``dWq = dqᵀ·xn`` and ``dWo =
    dyᵀ·oattn`` as plain GEMMs with f32 accumulation, rounded to the
    weights' dtype, as JAX left them to XLA.  ``dx`` is ``dy`` (the
    residual); dk and dv flow back to whatever made k and v."""

    @staticmethod
    def forward(ctx, x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale):
        if x.device.type == "cpu":
            y, q, oattn, lse = fused_cross_attention_forward_reference(
                x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale)
        else:
            y, q, oattn, lse = _launch_forward(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale,
                                               training=True)
        ctx.save_for_backward(xn, q, k, v, oattn, lse, wq, wo)
        ctx.config = (heads, dh_k, dh_v, scale)
        ctx.bo_dtype = bo.dtype
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xn, q, k, v, oattn, lse, wq, wo = ctx.saved_tensors
        dy = dy.contiguous()
        dxn, dq, dk, dv, dbo = fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo,
                                                              *ctx.config)
        return (dy, dxn, weight_grad(dq, xn), dk, dv, weight_grad(dy, oattn),
                dbo.to(ctx.bo_dtype), None, None, None, None)


def fused_cross_attention(x, xn, wq, k, v, wo, bo, heads: int, dh_k: int, dh_v: int,
                          scale: float | None = None):
    """``x + (softmax((xn·Wqᵀ)·kᵀ·scale)·v)·Woᵀ + bo`` per head, with
    precomputed k and v; ``scale`` defaults to ``dh_k ** -0.5``.

    Layouts as in the module docstring; on CUDA every tensor in x's dtype
    (bf16 or f16), contiguous.  When autograd records the call, it goes
    through :class:`FusedCrossAttentionFunction`; otherwise a CPU tensor
    takes the plain version and a CUDA tensor launches the serving forward,
    which returns y alone.  On CUDA it launches or raises.
    ``fused_cross_attention.launches`` counts forward kernel launches.
    """
    scale = _scale(dh_k, scale)
    if needs_grad(x, xn, wq, k, v, wo, bo):
        return FusedCrossAttentionFunction.apply(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v,
                                                 scale)
    if x.device.type == "cpu":
        return fused_cross_attention_reference(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale)
    return _launch_forward(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale)[0]


fused_cross_attention.launches = 0
