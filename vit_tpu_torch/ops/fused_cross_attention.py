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
reduction up to 128 channels and heads·dh_k 256, elsewhere ``cross_bwd``
between the doattn and dxn GEMMs, past 128 keys the doattn and dxn GEMMs, the
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
keeps doattn, p and ds on chip, reads no oattn or lse, and splits each image's
queries into spans that fill the card, their f32 dk and dv partials summed
in a fixed order.

Numerics, mirrored by the plain versions: ``q = T(xn·Wqᵀ)``; logits in f32;
P rounded to the compute dtype for P·V and the f32 row sum divided out after
it (``vit_tpu``'s late divide, ``:98-104``); oattn rounded; the residual adds
in the compute dtype.  Backward: ``doattn = T(dy·Wo)``; p recomputed as
the softmax of its row, as the TPU kernel recomputes it (so a single key
gives p = 1 exactly and ds = 0), ``dp = doattn·vᵀ`` and the TPU kernel's
``dsum = Σ p·dp`` (``:150``; the four-step route past 128 keys takes p from
the saved lse and ``D = rowsum(doattn∘oattn)`` from the stored output
instead: equal in f32); ``ds = T(p·(dp - dsum)·scale)``;
dq, dk, dv rounded once; ``dxn = T(dq·Wq)``; ``dbo`` the f32 sum of dy.  In
f32 the plain versions are exact attention and its gradient.

Layouts: x, xn ``(b, n, c)``; k ``(b, n_k, heads·dh_k)``; v ``(b, n_k,
heads·dh_v)``; ``wq`` ``(heads·dh_k, c)`` and ``wo`` ``(c, heads·dh_v)`` in
``nn.Linear`` layout (``vit_tpu`` takes their transposes); ``bo`` ``(c,)``.

Tensor parallelism (``group=``, the mesh's model group): each rank holds
its heads' rows of Wq, columns of Wo and columns of the packed k and v
(``heads`` the local count), and the split form
(:func:`fused_cross_attention_partial_forward`,
:func:`fused_cross_attention_partial_backward`; C's
``vit_fused_cross_attention_{fwd,bwd}_partial``) stops at the reductions:
the forward at the f32 partial ``s = oattn·Woᵀ``, which the ranks sum before
:func:`~vit_tpu_torch.ops.tensor_parallel.bias_residual` ends the block
(``T(x + T(Σ s + bo))``); the backward at the f32 partial ``dxn = dq·Wq``,
which leaves the Function unrounded when xn is given in f32, so that the
caller sums it with the k/v convolution's share and over the ranks before
one rounding.  dk and dv are the rank's heads'; ``dbo`` comes from the
whole dy.  ``vit_tpu`` has no counterpart: there GSPMD gathers the Pallas
call's operands and keeps the unsharded numbers.  Plain versions:
:func:`fused_cross_attention_partial_forward_reference`,
:func:`fused_cross_attention_partial_backward_reference`.
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
from vit_tpu_torch.ops.tensor_parallel import all_reduce_sum, bias_residual


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
    p is the softmax of its row and dsum = Σ p·dp, as ``cross_bwd`` and the
    TPU kernel take them; ``stored_output_d`` takes p from ``lse`` and D =
    rowsum(doattn∘oattn) instead, as the four-step backward (route 0 of
    :func:`backward_route`) does."""
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
    GEMMs inside, and its reduction (up to 128 channels and heads·dh_k 256:
    ScalableViT's stages 1-2); 2, ``cross_bwd`` between those two GEMMs
    (``launch_dgrad``: ``gemm_wgmma`` from 256 columns, ``linear.cu``
    below) from 129 channels or past heads·dh_k 256 (ScalableViT's stages
    3-4, Twins-SVT's four global attentions at 8 heads of 64); 0, the four
    steps (past 128 keys, or head widths ``cross_bwd`` has no instance for).  With
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


def _launch_backward(dy, q, k, v, oattn, lse, wq, wo, heads, dh_k, dh_v, scale, route=None,
                     dxn=None):
    """``vit_fused_cross_attention_bwd`` on CUDA tensors, each passed as it
    lies (the kernels read q, k, v, oattn and dy channel-packed through
    their strides, Wq and Wo in nn.Linear layout), with the one scratch
    buffer the library sizes for the route; given an f32 ``dxn``, the split
    form's ``vit_fused_cross_attention_bwd_partial`` into it."""
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
    partial = dxn is not None
    if not partial:
        dxn = torch.empty_like(dy)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
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
        entry = "vit_fused_cross_attention_bwd" + ("_partial" if partial else "")
        err = getattr(lib, entry)(
            dy.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(), oattn.data_ptr(),
            lse.data_ptr(), wq.data_ptr(), wo.data_ptr(), dxn.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dbo.data_ptr(), scratch.data_ptr(), *shape[:-1],
            float(scale), shape[-1], _build.DTYPE_CODES[dy.dtype], launch_stream(dy))
    _build.check(err, entry)
    if not partial:
        fused_cross_attention_backward.launches += 1
    BACKWARD_ROUTES[taken].launches += 1
    return dxn, dq, dk, dv, dbo


fused_cross_attention_backward.launches = 0


def fused_cross_attention_partial_forward_reference(xn, wq, k, v, wo, heads: int, dh_k: int,
                                                    dh_v: int, scale: float | None = None):
    """Plain PyTorch version of the split form's forward: ``(s, q, oattn,
    lse)``, ``s = oattn·Woᵀ`` in f32 (no bias, no residual) over this rank's
    ``heads`` (``wq`` ``(heads·dh_k, c)``, ``wo`` ``(c, heads·dh_v)``, k and v
    the rank's heads' columns), q, oattn and lse as
    :func:`fused_cross_attention_forward_reference` gives them.  In f32 the
    sum of the ranks' s plus bo and x is that function's y."""
    q = F.linear(xn.float(), wq.float()).to(xn.dtype)
    oattn, lse = flash_attention_packed_forward_reference(q, k, v, heads, _scale(dh_k, scale))
    return F.linear(oattn.float(), wo.float()), q, oattn, lse


def fused_cross_attention_partial_backward_reference(dy, q, k, v, oattn, lse, wq, wo,
                                                     heads: int, dh_k: int, dh_v: int,
                                                     scale: float | None = None,
                                                     stored_output_d: bool = False):
    """Plain PyTorch version of the split form's backward: ``(dxn, dq, dk,
    dv, dbo)`` as :func:`fused_cross_attention_backward_reference` gives
    them over this rank's heads, but ``dxn = dq·Wq`` in f32, unrounded (the
    rank's partial); ``dbo`` the f32 sum of the whole dy."""
    dt = dy.dtype
    c = dy.shape[-1]
    dy32 = dy.reshape(-1, c).float()
    doattn = (dy32 @ wo.float()).to(dt).reshape(oattn.shape)
    dq, dk, dv = flash_attention_packed_backward_reference(q, k, v, oattn, lse, doattn, heads,
                                                           _scale(dh_k, scale),
                                                           exact_dsum=not stored_output_d)
    dxn = (dq.reshape(-1, q.shape[-1]).float() @ wq.float()).reshape(dy.shape)
    return dxn, dq, dk, dv, dy32.sum(0)


def fused_cross_attention_partial_forward(xn, wq, k, v, wo, heads: int, dh_k: int, dh_v: int,
                                          scale: float | None = None, training: bool = False):
    """The split form's forward: what
    :func:`fused_cross_attention_partial_forward_reference` returns (q and
    lse None when serving a shape ``cross_fwd`` takes).  A CPU tensor takes
    the plain version; a CUDA tensor launches
    ``vit_fused_cross_attention_fwd_partial`` or raises.
    ``fused_cross_attention_partial_forward.launches`` counts kernel
    launches."""
    scale = _scale(dh_k, scale)
    if xn.device.type == "cpu":
        return fused_cross_attention_partial_forward_reference(xn, wq, k, v, wo, heads, dh_k,
                                                               dh_v, scale)
    b, n, c = xn.shape
    n_k = k.shape[1]
    hk, hv = heads * dh_k, heads * dh_v
    _check("fused_cross_attention (split)", xn, n_k, heads, dh_k, dh_v, {
        "wq": (wq, (hk, c)), "k": (k, (b, n_k, hk)), "v": (v, (b, n_k, hv)),
        "wo": (wo, (c, hv))})
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=xn.device)
    s = torch.empty((b, n, c), **f32)
    oattn = torch.empty((b, n, hv), dtype=xn.dtype, device=xn.device)
    q = lse = None
    if training or lib.vit_fused_cross_attention_partial_route(b, n, n_k, c, heads, dh_k,
                                                               dh_v) == 0:
        q = torch.empty((b, n, hk), dtype=xn.dtype, device=xn.device)
        lse = torch.empty((b, heads, n), **f32)
    with torch.cuda.device(xn.device):
        err = lib.vit_fused_cross_attention_fwd_partial(
            xn.data_ptr(), wq.data_ptr(), k.data_ptr(), v.data_ptr(), wo.data_ptr(),
            s.data_ptr(), None if q is None else q.data_ptr(), oattn.data_ptr(),
            None if lse is None else lse.data_ptr(), b, n, n_k, c, heads, dh_k, dh_v,
            float(scale), _build.DTYPE_CODES[xn.dtype], launch_stream(xn))
    _build.check(err, "vit_fused_cross_attention_fwd_partial")
    fused_cross_attention_partial_forward.launches += 1
    return s, q, oattn, lse


fused_cross_attention_partial_forward.launches = 0


def partial_backward_route(b: int, n: int, n_k: int, c: int, heads: int, dh_k: int,
                           dh_v: int) -> int:
    """The split backward's route at a shape: 2 (``cross_bwd`` between the
    doattn and dxn GEMMs) wherever :func:`backward_route` gives 1 or 2, else
    0 (the four steps): route 1 rounds dxn inside its kernel.  The one place
    this is decided: the C entry takes the route it is given and refuses
    route 1."""
    route = backward_route(b, n, n_k, c, heads, dh_k, dh_v)
    return 2 if route == 1 else route


def fused_cross_attention_partial_backward(dy, q, k, v, oattn, lse, wq, wo, heads: int,
                                           dh_k: int, dh_v: int, scale: float | None = None):
    """The split form's backward: what
    :func:`fused_cross_attention_partial_backward_reference` returns (with
    ``stored_output_d`` on route 0).  A CPU tensor takes the plain version;
    a CUDA tensor launches ``vit_fused_cross_attention_bwd_partial`` on
    :func:`partial_backward_route`'s route or raises.
    ``fused_cross_attention_partial_backward.launches`` counts kernel
    launches and ``BACKWARD_ROUTES[r]`` those on route r."""
    scale = _scale(dh_k, scale)
    if dy.device.type == "cpu":
        return fused_cross_attention_partial_backward_reference(dy, q, k, v, oattn, lse, wq, wo,
                                                                heads, dh_k, dh_v, scale)
    b, n, c = dy.shape
    n_k = k.shape[1]
    route = partial_backward_route(b, n, n_k, c, heads, dh_k, dh_v)
    dxn = torch.empty(dy.shape, dtype=torch.float32, device=dy.device)
    outs = _launch_backward(dy, q, k, v, oattn, lse, wq, wo, heads, dh_k, dh_v, scale, route,
                            dxn=dxn)
    fused_cross_attention_partial_backward.launches += 1
    return outs


fused_cross_attention_partial_backward.launches = 0


def _split_forward(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale, group, training):
    """A split block's forward: the partial, its sum over ``group``, the
    pass; ``(y, q, oattn, lse)``."""
    s, q, oattn, lse = fused_cross_attention_partial_forward(xn, wq, k, v, wo, heads, dh_k, dh_v,
                                                             scale, training)
    return bias_residual(all_reduce_sum(s, group), bo, x), q, oattn, lse


class FusedCrossAttentionFunction(torch.autograd.Function):
    """The op under autograd (``_vjp_fwd`` / ``_vjp_bwd``): the training
    forward keeps ``xn, q, k, v, oattn, lse``; the backward runs the backward
    kernels, then the weight gradients ``dWq = dqᵀ·xn`` and ``dWo =
    dyᵀ·oattn`` as plain GEMMs with f32 accumulation, rounded to the
    weights' dtype, as JAX left them to XLA.  ``dx`` is ``dy`` (the
    residual); dk and dv flow back to whatever made k and v.  With
    ``group`` (the model group of a split block) the forward is the split
    form, its partial summed over the group, then the pass; the backward the
    split backward, its dxn the rank's f32 partial (in xn's dtype: f32 where
    xn is given in f32, which the kernels read rounded to x's dtype); the
    weight gradients stay this rank's."""

    @staticmethod
    def forward(ctx, x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale, group=None):
        xc = xn.to(x.dtype)
        if group is not None:
            y, q, oattn, lse = _split_forward(x, xc, wq, k, v, wo, bo, heads, dh_k, dh_v, scale,
                                              group, training=True)
        elif x.device.type == "cpu":
            y, q, oattn, lse = fused_cross_attention_forward_reference(
                x, xc, wq, k, v, wo, bo, heads, dh_k, dh_v, scale)
        else:
            y, q, oattn, lse = _launch_forward(x, xc, wq, k, v, wo, bo, heads, dh_k, dh_v, scale,
                                               training=True)
        ctx.save_for_backward(xc, q, k, v, oattn, lse, wq, wo)
        ctx.config = (heads, dh_k, dh_v, scale)
        ctx.group = group
        ctx.dtypes = (xn.dtype, bo.dtype)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        xn, q, k, v, oattn, lse, wq, wo = ctx.saved_tensors
        dy = dy.contiguous()
        backward = fused_cross_attention_backward if ctx.group is None \
            else fused_cross_attention_partial_backward
        dxn, dq, dk, dv, dbo = backward(dy, q, k, v, oattn, lse, wq, wo, *ctx.config)
        xn_dtype, bo_dtype = ctx.dtypes
        return (dy, dxn.to(xn_dtype), weight_grad(dq, xn), dk, dv, weight_grad(dy, oattn),
                dbo.to(bo_dtype), None, None, None, None, None)


def fused_cross_attention(x, xn, wq, k, v, wo, bo, heads: int, dh_k: int, dh_v: int,
                          scale: float | None = None, group=None):
    """``x + (softmax((xn·Wqᵀ)·kᵀ·scale)·v)·Woᵀ + bo`` per head, with
    precomputed k and v; ``scale`` defaults to ``dh_k ** -0.5``.

    Layouts as in the module docstring; on CUDA every tensor in x's dtype
    (bf16 or f16), contiguous.  When autograd records the call, it goes
    through :class:`FusedCrossAttentionFunction`; otherwise a CPU tensor
    takes the plain version and a CUDA tensor launches the serving forward,
    which returns y alone.  On CUDA it launches or raises.
    ``fused_cross_attention.launches`` counts forward kernel launches.

    ``group``: the model group of a split block (tensor parallelism), whose
    ``wq``, ``wo``, k, v and ``heads`` are this rank's (module docstring);
    the call runs the split form on either device, its launches counted on
    ``fused_cross_attention_partial_forward.launches``.  There xn may be
    given in f32: its gradient is then the rank's f32 partial, unrounded.
    """
    scale = _scale(dh_k, scale)
    if needs_grad(x, xn, wq, k, v, wo, bo):
        return FusedCrossAttentionFunction.apply(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v,
                                                 scale, group)
    if group is not None:
        return _split_forward(x, xn.to(x.dtype), wq, k, v, wo, bo, heads, dh_k, dh_v, scale,
                              group, training=False)[0]
    return fused_cross_attention_op(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, float(scale))


fused_cross_attention.launches = 0


@torch.library.custom_op("vit_tpu_torch::fused_cross_attention", mutates_args=(),
                         device_types="cuda")
def fused_cross_attention_op(x: torch.Tensor, xn: torch.Tensor, wq: torch.Tensor,
                             k: torch.Tensor, v: torch.Tensor, wo: torch.Tensor,
                             bo: torch.Tensor, heads: int, dh_k: int, dh_v: int,
                             scale: float) -> torch.Tensor:
    """The serving forward as a registered op, which ``torch.export`` keeps
    as one node: on CUDA the kernels (:func:`_launch_forward`, counted), on
    the CPU :func:`fused_cross_attention_reference`."""
    return _launch_forward(x, xn, wq, k, v, wo, bo, heads, dh_k, dh_v, scale)[0]


fused_cross_attention_op.register_kernel("cpu")(fused_cross_attention_reference)


@fused_cross_attention_op.register_fake
def _(x, *args):
    return torch.empty_like(x)
