"""Fused pre-norm attention block: ``x + out_proj(attn(qkv(LN(x))))``,
forward and backward, with or without an additive logits bias.

Port of ``vit_tpu/ops/fused_attention_block.py::fused_attention_block`` and
``::fused_attention_block_bias``: the TPU forward kernel ``_fwd_kernel``
(driven by ``_forward``) and the backward kernel ``_bwd_kernel``
(``_backward``), each with the optional ``bias_ref`` / ``dbias_ref``, with the
custom VJPs (``_vjp_fwd`` / ``_vjp_bwd`` and their ``_bias`` twins) as
:class:`FusedAttentionBlockFunction`.  On a CUDA tensor the forward launches
the hand-written kernels of ``vit_tpu_torch/csrc/fused_attention_block.cu``
and the backward launches ``vit_fused_attention_block_bwd``
(:func:`fused_attention_block_backward`,
:func:`fused_attention_block_bias_backward`); on a CPU tensor both run their
plain PyTorch versions, :func:`fused_attention_block_forward_reference` and
:func:`fused_attention_block_backward_reference`.  The biased op
(:func:`fused_attention_block_bias`) counts its launches apart from the
unbiased one.

The attention middle takes one of two routes, by shape alone, the same in
both directions (:func:`attention_route`, counted in ``FORWARD_ROUTES`` and
``BACKWARD_ROUTES``): at n ≤ 512, with or without a bias, ``short_fwd`` and
``short_bwd`` of ``csrc/short_attention.cu`` over strided views of the packed
qkv (:func:`short_forward_views`, :func:`short_route_views`), the bias read
into their score fragments, the training forward keeping the lse the
backward reads, and dbias from the row statistics (lse, D) ``short_bwd``
writes (their plain versions
:func:`fused_attention_block_short_forward_reference` and
:func:`fused_attention_block_short_backward_reference`); past 512 tokens,
``mha_fwd`` and ``mha_bwd`` of ``csrc/attention.cu``.

What bounds it on the H100: at ViT-B/16, batch 64 (12,608 rows, d=768,
12 heads of 64) the QKV and output GEMMs are about 59.5 GFLOP per block and
the attention products 7.6 GFLOP (the backward: 59.5 and 19), all far above
the card's FLOP-per-byte ridge, so the tensor cores bound it.  The design
runs the GEMMs on ``gemm_wgmma.cu``'s warp-specialised wgmma GEMM (from n =
256), reads q/k/v strided out of the packed projection (no head-split
transpose), keeps the n×n probabilities in registers (whole rows in the short
forward, an online softmax in ``mha_fwd``; recomputed from per-row
log-sum-exp in the backward), fuses bias and residual into the
out-projection epilogue, and runs the LayerNorm and its backward as small
memory-bound passes.

Numerics, mirrored by the plain versions: f32 LayerNorm statistics (biased
two-pass variance), xn rounded to the compute dtype; qkv rounded before the
attention; logits in f32, ``scale`` applied to the f32 logits; on the mha
route the probabilities rounded to the compute dtype for P·V and divided by
the f32 row sum afterwards (the TPU kernel's late divide), on the short route
``p = e / l`` rounded before P·V (``short_attention``'s) without a bias and
the late divide with one; the attention
output rounded before the out-projection; the residual adds in the compute
dtype.  In f32 the two routes compute one function.  Backward: ``doattn``
rounded; p recomputed in f32; ``dsum = Σ dp·p`` from the f32 p and dp (not
from the rounded output); ``T(p)`` for dv and ``ds = T(p·(dp - dsum)·scale)``
for dq and dk, each rounded; the qkv dgrad ``dxn`` kept in f32; dγ, dβ and dbo
summed in f32.  The short route takes ``p = exp(s·scale + bias - lse)`` from the
forward's f32 lse and ``D = rowsum(dO∘O)`` from the stored, rounded attention
output in place of dsum: the same quantity in exact arithmetic, apart by O's
rounding in bf16.  The TPU padded odd token counts on the host and masked with
-1e30; the CUDA kernels mask ragged keys themselves with -inf.  The bias,
``(hb, n, n)`` f32 with hb 1 (shared by the heads) or ``heads``, is added in
f32 to the scaled f32 logits before the row max, in the forward and in the
backward's recomputed softmax; its gradient ``dbias`` is the f32 sum over the
batch (and over the heads when hb = 1) of ``p·(dp - dsum)``, taken before
the scale (on the short route with ``D`` for dsum), computed only when asked
for.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import check_kernel_tensors, launch_stream, needs_grad
from vit_tpu_torch.ops._shared import (
    data_ptr, ln_backward_reference, ln_bwd_scratch, ln_stats, weight_grad,
)
from vit_tpu_torch.ops.flash_attention import _tma_problem, kernel_strides
from vit_tpu_torch.ops.short_attention import (
    MAX_SEQ, short_attention_backward_reference, short_attention_forward_reference,
)

SUPPORTED_DIM_HEAD = (32, 64, 128)

# Launches of the attention middle by route (attention_route), each direction.
FORWARD_ROUTES = {"short": SimpleNamespace(launches=0), "mha": SimpleNamespace(launches=0)}
BACKWARD_ROUTES = {"short": SimpleNamespace(launches=0), "mha": SimpleNamespace(launches=0)}


def attention_route(n: int) -> str:
    """The attention middle at n tokens, forward and backward alike, with or
    without a logits bias: ``"short"``
    (``short_fwd``, whole rows, keeping lse in training; ``short_bwd``, one
    recompute of p per key block from that lse; the bias added in both, dbias
    from ``short_bwd``'s row statistics) for a block of at most 512 tokens
    (ViT-B/32's 65, ViT-B/16's 197, the small-dataset ViT's 257); ``"mha"``
    (``mha_fwd`` and ``mha_bwd``, any n) past them.  By shape only, so the
    lse and O that ``short_bwd`` reads always come from ``short_fwd``.  With
    a bias the threshold was timed at n 257 only (the small-dataset ViT's
    block), not in between."""
    return "short" if n <= MAX_SEQ else "mha"


def fused_attention_block_forward_reference(x, gamma, beta, wqkv, wo, bo, heads: int,
                                            dim_head: int, scale: float | None = None,
                                            eps: float = 1e-3, bias=None):
    """Plain PyTorch version of the training forward, same rounding points as
    the kernels: returns ``(y, xn, qkv, oattn)``, the residuals the backward
    needs.

    ``x``: ``(b, n, d)``; ``wqkv``: ``(3·heads·dim_head, d)`` with q|k|v
    thirds and head ``h`` at rows ``h·dim_head…``; ``wo``:
    ``(d, heads·dim_head)``; ``bo``: ``(d,)`` (``nn.Linear`` layout);
    ``bias``: ``None`` or ``(1 | heads, n, n)``, added to the scaled logits.
    """
    if scale is None:
        scale = dim_head ** -0.5
    dt = x.dtype
    xn, qkv = _ln_qkv(x, gamma, beta, wqkv, eps)
    q, k, v = (_split_heads(t, heads, dim_head) for t in qkv.chunk(3, dim=-1))
    s = _logits(q, k, scale, bias)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e.to(dt).float() @ v) / e.sum(-1, keepdim=True)
    oattn = _merge_heads(o.to(dt))
    return _out_projection(x, oattn, wo, bo), xn, qkv, oattn


def fused_attention_block_short_forward_reference(x, gamma, beta, wqkv, wo, bo, heads: int,
                                                  dim_head: int, scale: float | None = None,
                                                  eps: float = 1e-3, bias=None):
    """Plain PyTorch version of the training forward on the short route
    (:func:`attention_route`): ``(y, xn, qkv, oattn, lse)``, the first four
    as :func:`fused_attention_block_forward_reference` returns them, with the
    attention as ``short_fwd`` takes it over the packed qkv
    (``short_attention``'s plain version: ``p = e / l`` rounded before P·V;
    with a ``bias``, added to the scaled logits, the rounded unnormalised p
    and the divide after, as the mha route) and its f32 ``(b, heads, n)``
    lse.  In f32 the two are one function."""
    if scale is None:
        scale = dim_head ** -0.5
    xn, qkv = _ln_qkv(x, gamma, beta, wqkv, eps)
    oattn = torch.empty(x.shape[:-1] + (heads * dim_head,), dtype=x.dtype, device=x.device)
    q, k, v, o = short_forward_views(qkv, oattn, heads, dim_head)
    out, lse = short_attention_forward_reference(q, k, v, scale, bias)
    o.copy_(out)
    return _out_projection(x, oattn, wo, bo), xn, qkv, oattn, lse


def _ln_qkv(x, gamma, beta, wqkv, eps):
    """The LayerNorm and the QKV GEMM: ``(xn, qkv)``, each rounded to x's
    dtype."""
    dt = x.dtype
    x32 = x.float()
    mu, rstd = ln_stats(x32, eps)
    xn = ((x32 - mu) * rstd * gamma.float() + beta.float()).to(dt)
    return xn, F.linear(xn.float(), wqkv.float()).to(dt)


def _out_projection(x, oattn, wo, bo):
    """``T(x + T(oattn·Woᵀ + bo))``."""
    return x + F.linear(oattn.float(), wo.float(), bo.float()).to(x.dtype)


def fused_attention_block_reference(x, gamma, beta, wqkv, wo, bo, heads: int,
                                    dim_head: int, scale: float | None = None,
                                    eps: float = 1e-3, bias=None):
    """Plain PyTorch version of the serving forward: ``y`` of
    :func:`fused_attention_block_forward_reference`."""
    return fused_attention_block_forward_reference(x, gamma, beta, wqkv, wo, bo, heads,
                                                   dim_head, scale, eps, bias)[0]


def _logits(q, k, scale, bias):
    """f32 ``q·kᵀ·scale + bias`` over ``(b, heads, n, n)``; a ``(1, n, n)``
    bias is shared by the heads, a ``(heads, n, n)`` one is per head."""
    s = (q @ k.transpose(-1, -2)) * scale
    return s if bias is None else s + bias.float()


def _split_heads(t, heads, dim_head):
    """``(b, n, heads·dim_head)`` → f32 ``(b, heads, n, dim_head)``."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, dim_head).transpose(1, 2).float()


def _merge_heads(t):
    """``(b, heads, n, dim_head)`` → ``(b, n, heads·dim_head)``."""
    b, heads, n, dim_head = t.shape
    return t.transpose(1, 2).reshape(b, n, heads * dim_head)


def attention_lse_reference(qkv, heads: int, dim_head: int, scale: float | None = None,
                            bias=None):
    """Plain PyTorch version of the lse the training forward keeps for the
    short route: f32 ``(b, heads, n)``, the log-sum-exp of each query row's
    scaled f32 logits plus the ``bias``, if any."""
    if scale is None:
        scale = dim_head ** -0.5
    q, k, _ = (_split_heads(t, heads, dim_head) for t in qkv.chunk(3, dim=-1))
    return torch.logsumexp(_logits(q, k, scale, bias), dim=-1)


def fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads: int,
                                             dim_head: int, scale: float | None = None,
                                             eps: float = 1e-3, bias=None,
                                             need_dbias: bool = True):
    """Plain PyTorch version of the backward kernel (``_bwd_kernel``,
    ``vit_tpu/ops/fused_attention_block.py:169-258``), step by step with its
    rounding points.

    ``dy``, ``x``: ``(b, n, d)``; ``qkv``: the saved ``(b, n, 3·inner)``
    projection; ``gamma`` in the compute dtype; weights and ``bias`` as in
    :func:`fused_attention_block_forward_reference`.  Returns ``(dx, dqkv,
    dgamma, dbeta, dbo)``: the first two in the compute dtype, the sums in
    f32; with a ``bias``, ``dbias`` follows in f32 (``None`` unless
    ``need_dbias``).
    """
    if scale is None:
        scale = dim_head ** -0.5
    dt = dy.dtype
    d = x.shape[-1]
    dy32 = dy.reshape(-1, d).float()
    doattn = (dy32 @ wo.float()).to(dt).reshape(dy.shape[:-1] + (-1,))
    q, k, v = (_split_heads(t, heads, dim_head) for t in qkv.chunk(3, dim=-1))
    do = _split_heads(doattn, heads, dim_head)
    s = _logits(q, k, scale, bias)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = e / e.sum(-1, keepdim=True)
    dv = p.to(dt).float().transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    dsum = (dp * p).sum(-1, keepdim=True)
    ds0 = p * (dp - dsum)  # d(loss)/d(logits), before the scale
    ds = (ds0 * scale).to(dt).float()
    dq, dk = ds @ k, ds.transpose(-1, -2) @ q
    dqkv = torch.cat([_merge_heads(t.to(dt)) for t in (dq, dk, dv)], dim=-1)
    out = _through_the_projection(dy, x, dqkv, gamma, wqkv, eps)
    if bias is None:
        return out
    dbias = None
    if need_dbias:
        dbias = ds0.sum(0)
        if bias.shape[0] == 1:
            dbias = dbias.sum(0, keepdim=True)
    return out + (dbias,)


def _through_the_projection(dy, x, dqkv, gamma, wqkv, eps):
    """The backward after the attention: ``(dx, dqkv, dgamma, dbeta, dbo)``
    from dqkv, through the qkv dgrad into f32 and the LayerNorm backward."""
    d = x.shape[-1]
    dxn32 = dqkv.reshape(-1, dqkv.shape[-1]).float() @ wqkv.float()
    dx_ln, dgamma, dbeta = ln_backward_reference(x.reshape(-1, d).float(), dxn32,
                                                 gamma.float(), eps)
    dx = dy.reshape(-1, d) + dx_ln.to(dy.dtype)
    return dx.reshape(x.shape), dqkv, dgamma, dbeta, dy.reshape(-1, d).float().sum(0)


def _heads_of(t, heads, dim_head):
    """``(b, n, heads·dim_head)`` → a ``(b, heads, n, dim_head)`` view."""
    return t.unflatten(-1, (heads, dim_head)).transpose(1, 2)


def short_forward_views(qkv, oattn, heads: int, dim_head: int):
    """The ``(b, heads, n, dim_head)`` views the short route's ``short_fwd``
    reads and writes, as they lie: q, k and v (the column thirds of the
    packed ``(b, n, 3·inner)`` qkv: batch stride n·3·inner, head stride
    dim_head, row stride 3·inner) and O (oattn, ``(b, n, inner)``)."""
    return (*(_heads_of(t, heads, dim_head) for t in qkv.chunk(3, dim=-1)),
            _heads_of(oattn, heads, dim_head))


def short_route_views(qkv, oattn, doattn, dqkv, heads: int, dim_head: int):
    """The views the short route's ``short_bwd`` reads and writes, as they
    lie: those of :func:`short_forward_views`, then dO (doattn, as O) and dq,
    dk and dv (the thirds of dqkv, qkv's strides)."""
    return (*short_forward_views(qkv, oattn, heads, dim_head),
            _heads_of(doattn, heads, dim_head),
            *(_heads_of(t, heads, dim_head) for t in dqkv.chunk(3, dim=-1)))


def short_route_strides(name, views):
    """The (batch, head, row) element strides of the short route's views
    for the C entry points; raises ``ValueError`` on a view no TMA tensor map
    takes (:func:`_tma_problem`), before any launch."""
    for i, v in enumerate(views):
        problem = _tma_problem(v)
        if problem:
            raise ValueError(f"{name}: short-route view {i} has strides {v.stride()}, which "
                             f"no tensor map takes: {problem}")
    return kernel_strides(*views)


@functools.lru_cache(maxsize=64)
def _short_strides(b: int, n: int, heads: int, dim_head: int, backward: bool):
    """:func:`short_route_strides` of the views of contiguous 16-bit qkv
    ``(b, n, 3·inner)`` and oattn ``(b, n, inner)`` (:func:`short_forward_views`;
    with ``backward``, :func:`short_route_views` with doattn and dqkv laid
    out as oattn and qkv), once per shape: the wrappers pass contiguous,
    16-byte aligned tensors (``check_kernel_tensors``), whose strides follow
    from the shape, and building and checking eight views each call cost
    the host about 70 µs a block.  The C entry points read the array during
    the call only."""
    inner = heads * dim_head
    qkv = torch.empty((b, n, 3 * inner), dtype=torch.bfloat16, device="meta")
    oattn = torch.empty((b, n, inner), dtype=torch.bfloat16, device="meta")
    views = short_route_views(qkv, oattn, oattn, qkv, heads, dim_head) if backward \
        else short_forward_views(qkv, oattn, heads, dim_head)
    return short_route_strides("fused_attention_block", views)


def fused_attention_block_short_backward_reference(dy, x, qkv, oattn, lse, gamma, wqkv, wo,
                                                   heads: int, dim_head: int,
                                                   scale: float | None = None,
                                                   eps: float = 1e-3, bias=None,
                                                   need_dbias: bool = True):
    """Plain PyTorch version of the backward on the short route
    (:func:`attention_route`): ``(dx, dqkv, dgamma, dbeta, dbo)`` as
    :func:`fused_attention_block_backward_reference` returns them, with the
    attention's backward as ``short_bwd`` takes it: ``p = exp(s·scale + bias
    - lse)`` from the training forward's ``lse`` (``(b, heads, n)`` f32) and
    ``D = rowsum(dO∘O)`` from the stored attention output ``oattn``, where
    the TPU kernel sums ``dsum = Σ dp·p``; each product's output rounded as
    the kernel rounds it.  With a ``bias``, ``dbias`` follows in f32 (``None``
    unless ``need_dbias``), ``p·(dp - D)`` summed as the kernel's dbias pass
    sums it.  In f32 the two are one function."""
    if scale is None:
        scale = dim_head ** -0.5
    d = x.shape[-1]
    doattn = (dy.reshape(-1, d).float() @ wo.float()).to(dy.dtype).reshape(oattn.shape)
    dqkv = torch.empty_like(qkv)
    q, k, v, o, do, dq, dk, dv = short_route_views(qkv, oattn, doattn, dqkv, heads, dim_head)
    grads = short_attention_backward_reference(q, k, v, o, lse, do, scale, bias,
                                               need_dbias=bias is not None and need_dbias)
    for dst, src in zip((dq, dk, dv), grads):
        dst.copy_(src)
    out = _through_the_projection(dy, x, dqkv, gamma, wqkv, eps)
    if bias is None:
        return out
    return out + (grads[3] if need_dbias else None,)


def fused_attention_block_supported(d: int, heads: int, dim_head: int) -> bool:
    """Whether the kernel takes these widths: 16-byte rows and a head width
    the attention kernel is instantiated for."""
    return d % 8 == 0 and heads >= 1 and dim_head in SUPPORTED_DIM_HEAD


def _check_block(name, x, heads, dim_head, tensors):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (b, n, d), got {tuple(x.shape)}")
    d = x.shape[-1]
    if not fused_attention_block_supported(d, heads, dim_head):
        raise ValueError(
            f"{name} kernel needs d % 8 == 0 and dim_head in "
            f"{SUPPORTED_DIM_HEAD}, got d={d}, heads={heads}, "
            f"dim_head={dim_head}")
    check_kernel_tensors(name, x, tensors)


def check_bias(bias, x, heads: int) -> None:
    """A logits bias must be an f32 contiguous ``(1 | heads, n, n)`` tensor on
    ``x``'s device; anything else raises ``ValueError``."""
    n = x.shape[1]
    if not isinstance(bias, torch.Tensor) or bias.dtype != torch.float32 \
            or bias.dim() != 3 or bias.shape[0] not in (1, heads) \
            or tuple(bias.shape[1:]) != (n, n) or not bias.is_contiguous() \
            or bias.device != x.device:
        got = (f"{tuple(bias.shape)} {bias.dtype} on {bias.device}, contiguous="
               f"{bias.is_contiguous()}" if isinstance(bias, torch.Tensor) else type(bias))
        raise ValueError(f"fused_attention_block_bias: bias must be a contiguous f32 "
                         f"(1 or {heads}, {n}, {n}) tensor on {x.device}, got {got}")


def _bias_args(bias):
    """The C arguments of an optional bias: its pointer and head count."""
    return (0, 0) if bias is None else (bias.data_ptr(), bias.shape[0])


def _forward_buffers(x, heads: int, dim_head: int):
    """The forward's outputs and scratch for ``x`` ``(b, n, d)``: ``(y, xn,
    qkv, oattn)``.  xn and oattn are the GEMMs' A operands, read through 2-d
    TMA maps from n = 256, and qkv and oattn the short route's q|k|v and O
    (:func:`short_forward_views`): rows of d, 3·inner and inner elements,
    contiguous."""
    b, n, _ = x.shape
    inner = heads * dim_head
    qkv = torch.empty((b, n, 3 * inner), dtype=x.dtype, device=x.device)
    oattn = torch.empty((b, n, inner), dtype=x.dtype, device=x.device)
    return torch.empty_like(x), torch.empty_like(x), qkv, oattn


def _launch_forward(x, gamma, beta, wqkv, wo, bo, heads, dim_head, scale, eps, bias=None,
                    training=False):
    """The forward kernels on CUDA tensors: ``(y, xn, qkv, oattn, lse)``,
    every tensor but lse in ``x``'s dtype (bf16 or f16).  The attention by
    :func:`attention_route`, counted in ``FORWARD_ROUTES``.  The training
    forward keeps xn, qkv and oattn, as the TPU's ``save_residuals=True``,
    and on the short route also lse (f32 ``(b, heads, n)``, which the
    backward's ``short_bwd`` reads; None on the mha route and when serving);
    serving drops them.  ``fused_attention_block.launches`` counts the
    launches without a bias, ``fused_attention_block_bias.launches`` those
    with one."""
    b, n, d = x.shape
    inner = heads * dim_head
    _check_block("fused_attention_block", x, heads, dim_head, {
        "gamma": (gamma, (d,)), "beta": (beta, (d,)),
        "wqkv": (wqkv, (3 * inner, d)), "wo": (wo, (d, inner)), "bo": (bo, (d,)),
    })
    if bias is not None:
        check_bias(bias, x, heads)
    route = attention_route(n)
    y, xn, qkv, oattn = _forward_buffers(x, heads, dim_head)
    strides = lse = None
    if route == "short":
        strides = _short_strides(b, n, heads, dim_head, backward=False)
        if training:
            lse = torch.empty((b, heads, n), dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.vit_fused_attention_block_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), y.data_ptr(), xn.data_ptr(),
            qkv.data_ptr(), oattn.data_ptr(), lse.data_ptr() if lse is not None else None,
            strides, *_bias_args(bias), b, n, d, heads, dim_head, float(scale), eps,
            _build.DTYPE_CODES[x.dtype], launch_stream(x))
    _build.check(err, "vit_fused_attention_block_fwd")
    (fused_attention_block if bias is None else fused_attention_block_bias).launches += 1
    FORWARD_ROUTES[route].launches += 1
    return y, xn, qkv, oattn, lse


def fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads: int,
                                   dim_head: int, scale: float | None = None,
                                   eps: float = 1e-3, oattn=None, lse=None):
    """The backward kernel: what
    :func:`fused_attention_block_backward_reference` returns.  A CPU tensor
    takes the plain version; a CUDA tensor launches
    ``vit_fused_attention_block_bwd`` or raises.  Any n: at n ≤ 512 the
    attention goes the short route, which needs the training forward's
    ``oattn`` and ``lse`` (``_launch_forward(..., training=True)``); past it
    ``mha_bwd`` tiles both axes.  ``fused_attention_block_backward.launches``
    counts kernel launches."""
    if scale is None:
        scale = dim_head ** -0.5
    if dy.device.type == "cpu":
        return fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads,
                                                        dim_head, scale, eps)
    out = _launch_backward(dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps,
                           oattn=oattn, lse=lse)
    fused_attention_block_backward.launches += 1
    return out[:5]


fused_attention_block_backward.launches = 0


def fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads: int,
                                        dim_head: int, scale: float | None = None,
                                        eps: float = 1e-3, need_dbias: bool = True,
                                        oattn=None, lse=None):
    """The backward kernel with a logits bias: ``(dx, dqkv, dgamma, dbeta,
    dbo, dbias)`` as :func:`fused_attention_block_backward_reference` returns
    them, ``dbias`` computed (in a fixed order, the same bits every run) only
    when ``need_dbias``, else ``None``.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``vit_fused_attention_block_bwd`` or
    raises: at n ≤ 512 on the short route, which needs the training
    forward's ``oattn`` and ``lse``, as :func:`fused_attention_block_backward`.
    ``fused_attention_block_bias_backward.launches`` counts kernel launches."""
    if scale is None:
        scale = dim_head ** -0.5
    check_bias(bias, dy, heads)
    if dy.device.type == "cpu":
        return fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads,
                                                        dim_head, scale, eps, bias, need_dbias)
    out = _launch_backward(dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps, bias,
                           need_dbias, oattn=oattn, lse=lse)
    fused_attention_block_bias_backward.launches += 1
    return out


fused_attention_block_bias_backward.launches = 0


def _launch_backward(dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps, bias=None,
                     need_dbias=False, oattn=None, lse=None):
    """``vit_fused_attention_block_bwd`` on CUDA tensors: ``(dx, dqkv,
    dgamma, dbeta, dbo, dbias)``, ``dbias`` ``None`` unless asked for; the
    attention by :func:`attention_route`, counted in ``BACKWARD_ROUTES``."""
    b, n, d = dy.shape
    inner = heads * dim_head
    route = attention_route(n)
    short = route == "short"
    tensors = {
        "x": (x, dy.shape), "qkv": (qkv, (b, n, 3 * inner)), "gamma": (gamma, (d,)),
        "wqkv": (wqkv, (3 * inner, d)), "wo": (wo, (d, inner)),
    }
    if short and oattn is not None:
        tensors["oattn"] = (oattn, (b, n, inner))
    _check_block("fused_attention_block backward", dy, heads, dim_head, tensors)
    if short and (oattn is None or lse is None):
        raise ValueError(f"fused_attention_block backward: at n={n} the attention takes the "
                         f"short route, which needs the training forward's oattn and lse")
    if short and (lse.dtype != torch.float32 or tuple(lse.shape) != (b, heads, n)
                  or not lse.is_contiguous() or lse.device != dy.device):
        raise ValueError(f"fused_attention_block backward: lse must be a contiguous f32 "
                         f"({b}, {heads}, {n}) tensor on {dy.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    rows = b * n
    f32 = dict(dtype=torch.float32, device=dy.device)
    dx, dqkv = torch.empty_like(dy), torch.empty_like(qkv)
    sums_d = torch.empty(3 * d, **f32)
    doattn = torch.empty((b, n, inner), dtype=dy.dtype, device=dy.device)
    dxn, stats = ln_bwd_scratch(rows, d, dy.device)
    lib = _build.load()
    part_d = torch.empty((lib.vit_ln_bwd_partial_rows(rows), 3 * d), **f32)
    strides = dq_part = rowstat = dbias = dbias_part = None
    if short:
        strides = _short_strides(b, n, heads, dim_head, backward=True)
        parts = lib.vit_short_attention_parts(n, dim_head)
        if parts > 1:
            dq_part = torch.empty((parts, b, heads, n, dim_head), **f32)
    if not short or need_dbias:  # mha_bwd's scratch; the (lse, dsum) dbias reads
        rowstat = torch.empty((b, heads, n, 2), **f32)

    with torch.cuda.device(dy.device):
        if need_dbias:  # the part count follows the device's SM count
            hb = bias.shape[0]
            dbias = torch.empty((hb, n, n), **f32)
            dbias_part = torch.empty((lib.vit_attention_dbias_parts(b, n, heads, hb), hb, n, n),
                                     **f32)
        err = lib.vit_fused_attention_block_bwd(
            dy.data_ptr(), x.data_ptr(), qkv.data_ptr(), data_ptr(oattn), data_ptr(lse),
            gamma.data_ptr(), wqkv.data_ptr(), wo.data_ptr(),
            dx.data_ptr(), dqkv.data_ptr(), sums_d.data_ptr(), doattn.data_ptr(), strides,
            data_ptr(dq_part), data_ptr(rowstat), data_ptr(dxn), data_ptr(stats),
            part_d.data_ptr(), *_bias_args(bias), data_ptr(dbias), data_ptr(dbias_part), b, n, d,
            heads, dim_head, float(scale), eps, _build.DTYPE_CODES[dy.dtype], launch_stream(dy))
    _build.check(err, "vit_fused_attention_block_bwd")
    BACKWARD_ROUTES[route].launches += 1
    dgamma, dbeta, dbo = sums_d.view(3, d).unbind(0)
    return dx, dqkv, dgamma, dbeta, dbo, dbias


class FusedAttentionBlockFunction(torch.autograd.Function):
    """The op under autograd (``_vjp_fwd`` / ``_vjp_bwd``, and with a
    ``bias``, ``_vjp_fwd_bias`` / ``_vjp_bwd_bias``): the training forward
    keeps ``x``, ``xn``, ``qkv``, ``oattn`` and the bias, and on the card's
    short route (:func:`attention_route`) lse; the backward runs
    the backward kernel, then the weight gradients ``dWqkv = dqkvᵀ·xn`` and
    ``dWo = dyᵀ·oattn`` as plain GEMMs with f32 accumulation, rounded to the
    weights' dtype, as JAX left them to XLA.  ``gamma``/``beta`` may be f32
    master parameters: they are rounded to the compute dtype for the kernel,
    and their gradients come back in their own dtype from the f32 sums.
    ``dbias`` is computed only when autograd asks for it (a bias that does
    not require grad, as LSA's constant mask, never does)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wqkv, wo, bo, bias, heads, dim_head, scale, eps):
        gc, bc = gamma.to(x.dtype), beta.to(x.dtype)
        lse = None
        if x.device.type == "cpu":
            y, xn, qkv, oattn = fused_attention_block_forward_reference(
                x, gc, bc, wqkv, wo, bo, heads, dim_head, scale, eps, bias)
        else:
            y, xn, qkv, oattn, lse = _launch_forward(x, gc, bc, wqkv, wo, bo, heads, dim_head,
                                                     scale, eps, bias, training=True)
        ctx.save_for_backward(x, xn, qkv, oattn, lse, gc, wqkv, wo, bias)
        ctx.config = (heads, dim_head, scale, eps)
        ctx.param_dtypes = (gamma.dtype, beta.dtype, bo.dtype)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, xn, qkv, oattn, lse, gc, wqkv, wo, bias = ctx.saved_tensors
        dy = dy.contiguous()
        dbias = None
        if bias is None:
            dx, dqkv, dgamma, dbeta, dbo = fused_attention_block_backward(
                dy, x, qkv, gc, wqkv, wo, *ctx.config, oattn=oattn, lse=lse)
        else:
            dx, dqkv, dgamma, dbeta, dbo, dbias = fused_attention_block_bias_backward(
                dy, x, qkv, gc, wqkv, wo, bias, *ctx.config,
                need_dbias=ctx.needs_input_grad[6], oattn=oattn, lse=lse)
        gamma_dt, beta_dt, bo_dt = ctx.param_dtypes
        return (dx, dgamma.to(gamma_dt), dbeta.to(beta_dt), weight_grad(dqkv, xn),
                weight_grad(dy, oattn), dbo.to(bo_dt), dbias, None, None, None, None)


def fused_attention_block(x, gamma, beta, wqkv, wo, bo, heads: int,
                          dim_head: int, scale: float | None = None,
                          eps: float = 1e-3):
    """``x + (softmax(q·kᵀ·scale)·v)·Woᵀ + bo`` with ``q,k,v = LN(x)·Wqkvᵀ``.

    ``x`` is ``(b, n, d)``; weights as in
    :func:`fused_attention_block_forward_reference` and, on CUDA, in ``x``'s
    dtype (bf16 or f16); ``gamma``/``beta`` may be in any float dtype (f32
    master parameters) and are rounded to ``x``'s, as the TPU wrapper rounded
    them.  When autograd records the call, it goes through
    :class:`FusedAttentionBlockFunction`; otherwise a CPU tensor takes the
    plain version and a CUDA tensor launches the serving kernels, which keep
    no residuals.  On CUDA it launches or raises.
    ``fused_attention_block.launches`` counts forward kernel launches.
    """
    return _block(x, gamma, beta, wqkv, wo, bo, None, heads, dim_head, scale, eps)


fused_attention_block.launches = 0


def fused_attention_block_bias(x, gamma, beta, wqkv, wo, bo, bias, heads: int,
                               dim_head: int, scale: float | None = None,
                               eps: float = 1e-3):
    """:func:`fused_attention_block` plus an additive logits bias:
    ``x + (softmax(q·kᵀ·scale + bias)·v)·Woᵀ + bo``.

    ``bias`` is an f32 contiguous ``(1, n, n)`` tensor (shared by the heads:
    LSA's diagonal self-mask, CrossFormer's dynamic position bias) or
    ``(heads, n, n)`` (per head: RegionViT's relative position bias);
    anything else raises ``ValueError``.  It may require grad: its gradient
    is computed only then.  Dispatch as :func:`fused_attention_block`.
    ``fused_attention_block_bias.launches`` counts forward kernel launches,
    apart from the unbiased op's.
    """
    check_bias(bias, x, heads)
    return _block(x, gamma, beta, wqkv, wo, bo, bias, heads, dim_head, scale, eps)


fused_attention_block_bias.launches = 0


def _block(x, gamma, beta, wqkv, wo, bo, bias, heads, dim_head, scale, eps):
    if scale is None:
        scale = dim_head ** -0.5
    if needs_grad(x, gamma, beta, wqkv, wo, bo, bias):
        return FusedAttentionBlockFunction.apply(x, gamma, beta, wqkv, wo, bo, bias, heads,
                                                 dim_head, scale, eps)
    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    if x.device.type == "cpu":
        return fused_attention_block_reference(x, gamma, beta, wqkv, wo, bo,
                                               heads, dim_head, scale, eps, bias)
    return _launch_forward(x, gamma, beta, wqkv, wo, bo, heads, dim_head, scale, eps,
                           bias)[0]
