"""Fused transformer MLP block: ``x + fc2(gelu(fc1(LN(x))))``, forward and
backward.

Port of ``vit_tpu/ops/fused_mlp.py::fused_mlp`` / ``fused_mlp_3d``: the TPU
forward kernel ``_fwd_kernel`` (driven by ``_forward`` / ``_forward3``) and
the backward kernel ``_bwd_kernel`` (``_backward`` / ``_backward3``), with the
custom VJP (``_vjp_fwd`` / ``_vjp_bwd``) as :class:`FusedMLPFunction`.  On a
CUDA tensor the forward launches the hand-written kernels of
``vit_tpu_torch/csrc/fused_mlp.cu`` and the
backward launches ``vit_fused_mlp_bwd`` (:func:`fused_mlp_backward`); on a CPU
tensor both run their plain PyTorch versions, :func:`fused_mlp_forward_reference`
and :func:`fused_mlp_backward_reference`.

What bounds it on the H100: at ViT-B/16, batch 64, the block is two GEMMs
over 12,608 rows of d=768 with h=3072 (about 119 GFLOP against tens of MB of
activations and weights), forward and backward alike, so it is compute-bound
on the tensor cores.  The kernels therefore spend their design on the GEMMs
(``gemm_wgmma.cu``'s warp-specialised wgmma GEMM fed by TMA from n = 256,
``linear.cu``'s mma.sync one below it, f32 accumulation both), fuse the
bias, GELU, dGELU, residual and the db1 column sums into the epilogues, run
the LayerNorm as a small memory-bound pass, and its backward as the epilogue
of the dh·W1 dgrad on a thread-block cluster where d % 256 == 0 in
256..2048 (:func:`~vit_tpu_torch.ops._shared.ln_bwd_fused`; elsewhere as
passes over an f32 dxn in device memory); the extra traffic is xn, g and h
(see the source notes in the .cu files).

Numerics, mirrored by the plain versions: LayerNorm statistics in f32 with
the biased two-pass variance and eps inside the rsqrt; xn rounded to the
compute dtype before fc1; f32 accumulation; exact-erf GELU in f32 of the
unrounded pre-activation, rounded before fc2; the residual adds in the
compute dtype.  Training keeps ``h = T(xn·W1ᵀ + b1)``; the backward takes
GELU's derivative and re-emits ``gact = T(gelu(h))`` from that rounded h, keeps
the fc1 dgrad ``dxn`` in f32, and sums dγ, dβ, db1 (of the f32 dh) and db2 in
f32.  The TPU's production path used the tanh GELU because Mosaic has no
erf; CUDA has ``erff``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import check_kernel_tensors, launch_stream, needs_grad
from vit_tpu_torch.ops._shared import (
    data_ptr, ln_backward_reference, ln_bwd_scratch, ln_stats, weight_grad,
)

_INV_SQRT_2PI = 0.3989422804014327


def _dgelu(h32: torch.Tensor) -> torch.Tensor:
    """d/dh gelu_erf(h) = cdf + h·pdf (``vit_tpu/ops/fused_mlp.py:123-126``)."""
    cdf = 0.5 * (1.0 + torch.erf(h32 * 0.7071067811865476))
    return cdf + h32 * (_INV_SQRT_2PI * torch.exp(-0.5 * h32 * h32))


def fused_mlp_forward_reference(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-3):
    """Plain PyTorch version of the training forward, same rounding points as
    the kernel: returns ``(y, xn, h)`` with ``h = T(xn·W1ᵀ + b1)``, the
    pre-activation the backward needs.

    ``x``: ``(t, d)`` or ``(b, n, d)``; ``gamma``/``beta``: ``(d,)``;
    ``w1``: ``(h, d)``, ``b1``: ``(h,)``, ``w2``: ``(d, h)``, ``b2``: ``(d,)``
    (``nn.Linear`` layout).  GEMMs run in f32 on the compute-dtype values.
    """
    dt = x.dtype
    x32 = x.float()
    mu, rstd = ln_stats(x32, eps)
    xn = ((x32 - mu) * rstd * gamma.float() + beta.float()).to(dt)
    h32 = F.linear(xn.float(), w1.float(), b1.float())
    g = F.gelu(h32).to(dt)
    o32 = F.linear(g.float(), w2.float(), b2.float())
    return x + o32.to(dt), xn, h32.to(dt)


def fused_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-3):
    """Plain PyTorch version of the serving forward: ``y`` of
    :func:`fused_mlp_forward_reference`."""
    return fused_mlp_forward_reference(x, gamma, beta, w1, b1, w2, b2, eps)[0]


def fused_mlp_backward_reference(dy, x, h, gamma, w1, w2, eps: float = 1e-3):
    """Plain PyTorch version of the backward kernel (``_bwd_kernel``,
    ``vit_tpu/ops/fused_mlp.py:177-227``), step by step with its rounding
    points.

    ``dy``, ``x``: the block's cotangent and input, ``(..., d)``; ``h``: the
    saved pre-activation ``(..., hidden)``; ``gamma`` in the compute dtype;
    weights in ``nn.Linear`` layout.  Returns ``(dx, dh, gact, dgamma, dbeta,
    db1, db2)``: the first three in the compute dtype and the shapes of
    ``x``/``h``, the four sums in f32.
    """
    dt = dy.dtype
    d, hidden = x.shape[-1], h.shape[-1]
    dy2 = dy.reshape(-1, d)
    dy32 = dy2.float()
    h32 = h.reshape(-1, hidden).float()
    dh32 = (dy32 @ w2.float()) * _dgelu(h32)
    dh = dh32.to(dt)
    gact = F.gelu(h32).to(dt)
    dxn32 = dh.float() @ w1.float()
    dx_ln, dgamma, dbeta = ln_backward_reference(x.reshape(-1, d).float(), dxn32,
                                                 gamma.float(), eps)
    dx = dy2 + dx_ln.to(dt)
    return (dx.reshape(x.shape), dh.reshape(h.shape), gact.reshape(h.shape),
            dgamma, dbeta, dh32.sum(0), dy32.sum(0))


def fused_mlp_supported(d: int, hidden: int) -> bool:
    """Whether the kernels take these widths (16-byte rows: multiples of 8)."""
    return d % 8 == 0 and hidden % 8 == 0


def _check_widths(d: int, hidden: int) -> None:
    if not fused_mlp_supported(d, hidden):
        raise ValueError(
            f"fused_mlp kernel needs d and hidden to be multiples of 8, got "
            f"d={d}, hidden={hidden}")


def _forward_buffers(x, hidden: int, save_residuals: bool):
    """The forward's outputs and scratch for ``x``'s rows: ``(y, xn, g,
    h)``, ``h`` None unless ``save_residuals``.  xn and g are the GEMMs' A
    operands, read through 2-d TMA maps from n = 256: rows of d and hidden
    elements, contiguous."""
    rows = x.numel() // x.shape[-1]
    g = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    h = torch.empty(x.shape[:-1] + (hidden,), dtype=x.dtype, device=x.device) \
        if save_residuals else None
    return torch.empty_like(x), torch.empty_like(x), g, h


def _launch_forward(x, gamma, beta, w1, b1, w2, b2, eps: float, save_residuals: bool):
    """The forward kernel on CUDA tensors: ``(y, xn, h)``, with ``xn`` and
    ``h`` None unless ``save_residuals`` (the training forward keeps them, as
    the TPU's ``save_residuals=True``).  Every tensor in ``x``'s dtype (bf16
    or f16).  ``fused_mlp.launches`` counts the launches."""
    d = x.shape[-1]
    hidden = w1.shape[0]
    _check_widths(d, hidden)
    check_kernel_tensors("fused_mlp", x, {
        "gamma": (gamma, (d,)), "beta": (beta, (d,)),
        "w1": (w1, (hidden, d)), "b1": (b1, (hidden,)),
        "w2": (w2, (d, hidden)), "b2": (b2, (d,)),
    })
    rows = x.numel() // d
    y, xn, g, h = _forward_buffers(x, hidden, save_residuals)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.vit_fused_mlp_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            xn.data_ptr(), g.data_ptr(), h.data_ptr() if save_residuals else None,
            rows, d, hidden, eps, _build.DTYPE_CODES[x.dtype], launch_stream(x))
    _build.check(err, "vit_fused_mlp_fwd")
    fused_mlp.launches += 1
    return (y, xn, h) if save_residuals else (y, None, None)


def fused_mlp_backward(dy, x, h, gamma, w1, w2, eps: float = 1e-3):
    """The backward kernel: what :func:`fused_mlp_backward_reference`
    returns.  A CPU tensor takes the plain version; a CUDA tensor launches
    ``vit_fused_mlp_bwd`` or raises.  ``fused_mlp_backward.launches`` counts
    kernel launches."""
    if dy.device.type == "cpu":
        return fused_mlp_backward_reference(dy, x, h, gamma, w1, w2, eps)
    out = _launch_backward(dy, x, h, gamma, w1, w2, eps)
    fused_mlp_backward.launches += 1
    return out


fused_mlp_backward.launches = 0


def _launch_backward(dy, x, h, gamma, w1, w2, eps: float):
    """``vit_fused_mlp_bwd`` on CUDA tensors: ``(dx, dh, gact, dgamma, dbeta,
    db1, db2)``; the f32 dxn and row statistics only where the LayerNorm
    backward is not the dh·W1 dgrad's epilogue (:func:`ln_bwd_scratch`)."""
    d, hidden = x.shape[-1], w1.shape[0]
    _check_widths(d, hidden)
    check_kernel_tensors("fused_mlp backward", dy, {
        "x": (x, dy.shape), "h": (h, dy.shape[:-1] + (hidden,)), "gamma": (gamma, (d,)),
        "w1": (w1, (hidden, d)), "w2": (w2, (d, hidden)),
    })
    rows = dy.numel() // d
    dev = dy.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx, dh, gact = torch.empty_like(dy), torch.empty_like(h), torch.empty_like(h)
    sums_h = torch.empty(hidden, **f32)
    sums_d = torch.empty(3 * d, **f32)
    dxn, stats = ln_bwd_scratch(rows, d, dev)
    lib = _build.load()
    part_h = torch.empty((lib.vit_linear_partial_rows(rows), hidden), **f32)
    part_d = torch.empty((lib.vit_ln_bwd_partial_rows(rows), 3 * d), **f32)
    with torch.cuda.device(dev):
        err = lib.vit_fused_mlp_bwd(
            dy.data_ptr(), x.data_ptr(), h.data_ptr(), gamma.data_ptr(), w1.data_ptr(),
            w2.data_ptr(), dx.data_ptr(), dh.data_ptr(), gact.data_ptr(),
            sums_h.data_ptr(), sums_d.data_ptr(), data_ptr(dxn), data_ptr(stats),
            part_h.data_ptr(), part_d.data_ptr(), rows, d, hidden, eps,
            _build.DTYPE_CODES[dy.dtype], launch_stream(dy))
    _build.check(err, "vit_fused_mlp_bwd")
    dgamma, dbeta, db2 = sums_d.view(3, d).unbind(0)
    return dx, dh, gact, dgamma, dbeta, sums_h, db2


class FusedMLPFunction(torch.autograd.Function):
    """The op under autograd (``_vjp_fwd`` / ``_vjp_bwd``): the training
    forward keeps ``x``, ``xn`` and ``h``; the backward runs the backward
    kernel, then the weight gradients ``dW1 = dhᵀ·xn`` and ``dW2 = dyᵀ·gact``
    as plain GEMMs with f32 accumulation, rounded to the weights' dtype, as
    JAX left them to XLA.  ``gamma``/``beta`` may be f32 master parameters:
    they are rounded to the compute dtype for the kernel, and their gradients
    come back in their own dtype from the f32 sums."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, eps):
        gc, bc = gamma.to(x.dtype), beta.to(x.dtype)
        if x.device.type == "cpu":
            y, xn, h = fused_mlp_forward_reference(x, gc, bc, w1, b1, w2, b2, eps)
        else:
            y, xn, h = _launch_forward(x, gc, bc, w1, b1, w2, b2, eps, save_residuals=True)
        ctx.save_for_backward(x, xn, h, gc, w1, w2)
        ctx.eps = eps
        ctx.param_dtypes = (gamma.dtype, beta.dtype, b1.dtype, b2.dtype)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, xn, h, gc, w1, w2 = ctx.saved_tensors
        dx, dh, gact, dgamma, dbeta, db1, db2 = fused_mlp_backward(
            dy.contiguous(), x, h, gc, w1, w2, ctx.eps)
        gamma_dt, beta_dt, b1_dt, b2_dt = ctx.param_dtypes
        return (dx, dgamma.to(gamma_dt), dbeta.to(beta_dt), weight_grad(dh, xn),
                db1.to(b1_dt), weight_grad(dy, gact), db2.to(b2_dt), None)


def fused_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-3):
    """``x + fc2(gelu(fc1(LN(x))))`` over ``(t, d)`` or ``(b, n, d)`` rows.

    Weights in ``nn.Linear`` layout and, on CUDA, in ``x``'s dtype (bf16 or
    f16); ``gamma``/``beta`` may be in any float dtype (f32 master
    parameters) and are rounded to ``x``'s, as the TPU wrapper rounded them.
    When autograd records the call, it goes through
    :class:`FusedMLPFunction`; otherwise a CPU tensor takes
    :func:`fused_mlp_reference` and a CUDA tensor launches the serving
    kernel, which keeps no residuals.  On CUDA it launches or raises.
    ``fused_mlp.launches`` counts forward kernel launches.
    """
    if needs_grad(x, gamma, beta, w1, b1, w2, b2):
        return FusedMLPFunction.apply(x, gamma, beta, w1, b1, w2, b2, eps)
    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    if x.device.type == "cpu":
        return fused_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps)
    return _launch_forward(x, gamma, beta, w1, b1, w2, b2, eps, save_residuals=False)[0]


fused_mlp.launches = 0
