"""The short-sequence hybrid layer: ``ln_gemm → attention_nb → proj_mlp`` on
``(n, b, ·)`` rows, forward and backward.

Port of ``vit_tpu/ops/fused_hybrid.py``: ``ln_gemm`` (``_ln_gemm_fwd_kernel``,
``_ln_gemm_bwd_kernel``), ``attention_nb`` (``_attn_nb_fwd_kernel``,
``_attn_nb_bwd_kernel``) and ``proj_mlp`` (``_proj_mlp_fwd_kernel``,
``_proj_mlp_bwd_kernel``), each with its custom VJP as a
``torch.autograd.Function``.  On a CUDA tensor ``ln_gemm`` and ``proj_mlp``
launch the entry points of ``vit_tpu_torch/csrc/fused_hybrid.cu`` and
``attention_nb`` those of ``csrc/short_attention.cu`` (the kernels of
:mod:`vit_tpu_torch.ops.short_attention`, over ``(n, b, heads·dh)`` strides);
on a CPU tensor each runs its plain PyTorch version.

The layer (``vit_tpu/layers/common.py:190-255``): ``q|k|v = ln_gemm(x)`` with
the QKV weight, ``o = attention_nb(q, k, v)``, ``z = proj_mlp(x, o)`` with the
out-projection, the second LayerNorm and the MLP.  ``ln_gemm(nsplit=3)``
returns q, k and v as column views of one ``(t, 3·inner)`` output, the
attention reads them through their strides, and its backward writes dq, dk
and dv into one ``(t, 3·inner)`` buffer, which ``ln_gemm``'s backward takes as
it lies: no split and no concatenation either way.

Numerics, mirrored by the plain versions: as the fused MLP's
(:mod:`vit_tpu_torch.ops.fused_mlp`: LayerNorm statistics in f32, xn rounded
before its GEMM, f32 accumulation, exact-erf GELU, residuals added in the
compute dtype) and the short attention's; ``ln_gemm``'s backward returns
``dx = T(rstd·(dxhat - m1 - xhat·m2))`` (no residual) and f32 Σ dγ, Σ dβ.
``proj_mlp`` rounds ``y = T(x + T(o·Woᵀ + bo))`` twice and takes the second
LayerNorm's statistics from the stored y, where ``vit_tpu`` sums in f32 and
rounds once (``fused_hybrid.py:508-513``); its backward's ``dy = T(dz +
T(dx_ln))`` and ``dbo = Σ dy`` sum that rounded dy.  Differences in bf16
only: in f32 both are ``vit_tpu``'s function.  ``vit_tpu``'s ``block_t`` and
``interpret`` were TPU knobs, and its ``gelu`` choice a Mosaic one (no erf):
GELU is exact here.  Weights are ``nn.Linear``'s ``(out, in)``, as they lie.
The weight gradients are plain GEMMs (:func:`vit_tpu_torch.ops._shared.
weight_grad`), as ``vit_tpu`` left them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import check_kernel_tensors, launch_stream, needs_grad
from vit_tpu_torch.ops._shared import (
    LN_BWD_TILE, data_ptr, ln_backward_reference, ln_bwd_fused, ln_bwd_scratch, ln_stats,
    weight_grad,
)
from vit_tpu_torch.ops.fused_mlp import (
    _dgelu, fused_mlp_backward_reference, fused_mlp_forward_reference,
)
from vit_tpu_torch.ops.short_attention import (
    ShortAttentionFunction, nb_heads, nb_merge, short_attention_backward_nb,
    short_attention_backward_reference, short_attention_forward,
    short_attention_forward_reference,
)


def _attn_pack(heads: int, dim_head: int):
    """Heads per 128-lane block, or None: ``vit_tpu``'s gate of the tier
    (``vit_tpu/ops/fused_hybrid.py:307-314``), kept as the tier's gate."""
    if dim_head >= 128 and dim_head % 128 == 0:
        return 1
    if dim_head < 128 and 128 % dim_head == 0 and heads % (128 // dim_head) == 0:
        return 128 // dim_head
    return None


def _check_widths(name, *widths):
    if any(w % 8 for w in widths):
        raise ValueError(f"{name}: the kernels need widths that are multiples of 8, got {widths}")


def _f32(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


# ---- the GEMM: out = epi(a·Wᵀ) (the forward's), out = epi(a·W) (the dgrads') -------------

# csrc/kernels.cuh's Epilogue codes that csrc/gemm_wgmma.cu takes over an
# nn.Linear weight (n, k) (the forward GEMMs, ``layout="nk"``) and over one
# used as it lies, (k, n) (the blocks' dgrads, ``layout="kn"``).
GEMM_EPILOGUES = {"store": 0, "bias_gelu": 1, "bias_residual": 2, "bias_gelu_save": 3,
                  "f32": 5}
DGRAD_EPILOGUES = {"store": 0, "dgelu": 4, "f32": 5, "ln_bwd": 6}
_LAYOUTS = {"nk": (0, GEMM_EPILOGUES), "kn": (1, DGRAD_EPILOGUES)}
# Rows of one column-sum partial of the LayerNorm backward (layernorm.cu's
# kColChunk; a consumer warpgroup's rows in gemm_wgmma.cu's kEpiLnBwd).
_LN_PARTIAL_ROWS = 64


def _chunked_colsum(v):
    """Column sums of ``v`` ``(rows, m)`` as the kernels take them: sums of
    64-row chunks, the chunks added in order."""
    out = torch.zeros(v.shape[1], dtype=v.dtype, device=v.device)
    for chunk in v.split(_LN_PARTIAL_ROWS):
        out = out + chunk.sum(0)
    return out


def _tile_order(v):
    """Σ over the last axis (a row's 256-column tiles, at most 8) in the
    kernel's fixed order: ``((v0 + v4) + (v1 + v5)) + ((v2 + v6) + (v3 +
    v7))``, absent tiles as zeros (lane t of a quad reads tiles t and t + 4,
    the quad adds its lanes by two shuffles)."""
    lanes = [v[..., t] + (v[..., t + 4] if t + 4 < v.shape[-1] else 0.0) if t < v.shape[-1]
             else torch.zeros_like(v[..., 0]) for t in range(4)]
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def ln_bwd_epilogue_reference(dxn, x, gamma, dy=None, eps: float = 1e-3):
    """``kEpiLnBwd``'s function of the f32 ``dxn`` ``(rows, d)`` in the
    kernel's order of sums: ``(dx, dgamma, dbeta, dsum)``, dx in x's dtype,
    the sums in f32 (``dsum`` = Σ dy, None with no dy).

    Per row and 256-column tile t (a CTA of the cluster), with K the tile's
    first x of the row and c = x - K: s1 = Σ c, s2 = Σ c², D1_t = Σ dxhat,
    DK = Σ dxhat·c (dxhat = dxn·γ); S_t = 256·K + s1, mean_t = S_t / 256,
    M2_t = max(s2 - s1²/256, 0) = Σ (x - mean_t)², D2_t = DK - (s1/256)·D1_t
    = Σ dxhat·(x - mean_t); the tiles added in the kernel's fixed order
    (:func:`_tile_order`) into the row's mean = Σ S_t / d, rstd = rsqrt((Σ
    M2_t + 256·(mean_t - mean)²) / d + eps) (the biased variance, the tiles'
    pieces joined exactly), m1 = Σ D1_t / d and m2 = rstd·Σ (D2_t + (mean_t
    - mean)·D1_t) / d; then ``dx = T(dy +
    T(rstd·(dxhat - m1 - xhat·m2)))`` (no dy: the inner term), and the
    column sums Σ dxn·xhat, Σ dxn, Σ dy over 64-row chunks added in order.
    In exact arithmetic it is :func:`~vit_tpu_torch.ops._shared.
    ln_backward_reference`."""
    rows, d = dxn.shape
    x32, dxhat = x.float(), dxn * gamma.float()
    tiles = d // LN_BWD_TILE
    xt, ht = x32.view(rows, tiles, LN_BWD_TILE), dxhat.view(rows, tiles, LN_BWD_TILE)
    k0 = xt[..., 0]
    c = xt - k0[..., None]
    s1, d1_t = c.sum(-1), ht.sum(-1)
    sh = s1 * (1.0 / LN_BWD_TILE)
    parts = torch.stack([LN_BWD_TILE * k0 + s1,
                         (c.square().sum(-1) - s1 * sh).clamp_min(0.0), d1_t,
                         (ht * c).sum(-1) - sh * d1_t])  # (4, rows, tiles)
    inv_d = 1.0 / d
    mean, m1 = _tile_order(parts[0]) * inv_d, _tile_order(parts[2]) * inv_d
    dm = parts[0] * (1.0 / LN_BWD_TILE) - mean[:, None]
    q = _tile_order(parts[1] + LN_BWD_TILE * dm * dm)
    dd = _tile_order(parts[3] + dm * parts[2])
    rstd = torch.rsqrt(q * inv_d + eps)[:, None]
    m1, m2 = m1[:, None], rstd * (dd * inv_d)[:, None]
    xhat = (x32 - mean[:, None]) * rstd
    dx_ln = (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype)
    dx = dx_ln if dy is None else dy + dx_ln
    return (dx, _chunked_colsum(dxn * xhat), _chunked_colsum(dxn),
            None if dy is None else _chunked_colsum(dy.float()))


def gemm_reference(a, w, epilogue: str, bias=None, res=None, h=None, layout: str = "nk",
                   x=None, gamma=None, dy=None, eps: float = 1e-3):
    """Plain PyTorch version of ``gemm_wgmma.cu`` for ``a`` ``(rows, k)``
    and an ``nn.Linear`` weight ``w``, with the kernel's rounding points.

    ``layout="nk"`` (the hybrid layer's forward GEMMs), ``w`` ``(n, k)``,
    ``acc = a·wᵀ``: ``(out, h)``, out ``T(acc)``; ``T(gelu(acc + b))``;
    ``T(res + T(acc + b))``; and for ``"bias_gelu_save"`` also ``h = T(acc +
    b)``, the GELU taken of the unrounded sum (``h`` None for the others);
    ``"f32"`` gives ``(acc, None)``, a split block's f32 partial sum.

    ``layout="kn"`` (the blocks' dgrads), ``w`` ``(k, n)`` as it lies, ``acc
    = a·w``: ``"store"`` gives ``(T(acc), None)``, ``"f32"`` ``(acc, None)``,
    ``"dgelu"`` ``(dh, gact, db1)`` from the saved pre-activation ``h``: ``dh
    = T(acc·gelu'(h))``, ``gact = T(gelu(h))`` and ``db1`` the f32 column sums
    of the unrounded ``acc·gelu'(h)``, as the fused MLP's backward computes
    them; ``"ln_bwd"`` ``(dx, dgamma, dbeta, dsum)``, the LayerNorm backward
    of ``acc`` = dxn over ``x`` with ``gamma`` and the residual ``dy`` (or
    none), as :func:`ln_bwd_epilogue_reference` takes it (the widths of
    :func:`~vit_tpu_torch.ops._shared.ln_bwd_fused`)."""
    dt = a.dtype
    acc = a.float() @ (w.float().t() if layout == "nk" else w.float())
    if epilogue == "ln_bwd":
        return ln_bwd_epilogue_reference(acc, x, gamma, dy, eps)
    if epilogue == "store":
        return acc.to(dt), None
    if epilogue == "f32":
        return acc, None
    if epilogue == "dgelu":
        h32 = h.float()
        dh32 = acc * _dgelu(h32)
        return dh32.to(dt), F.gelu(h32).to(dt), dh32.sum(0)
    s = acc + bias.float()
    if epilogue == "bias_residual":
        return res + s.to(dt), None
    return F.gelu(s).to(dt), s.to(dt) if epilogue == "bias_gelu_save" else None


# The kernels ``vit_gemm`` runs one GEMM on: ``gemm_wgmma.cu``'s, or
# ``linear.cu``'s mma.sync one, which the blocks take below n = 256.
GEMM_KERNELS = {"wgmma": 0, "mma_sync": 1}


def gemm_wgmma(a, w, epilogue: str, bias=None, res=None, h=None, layout: str = "nk",
               kernel: str = "wgmma", x=None, gamma=None, dy=None, eps: float = 1e-3):
    """The GEMM alone: what :func:`gemm_reference` returns.  A CPU tensor
    takes the plain version; a CUDA tensor launches ``vit_gemm`` on
    ``gemm_wgmma.cu``'s kernel, or with ``kernel="mma_sync"`` on
    ``linear.cu``'s (at any n: the blocks' choice between them by width is in
    C), or raises; ``"ln_bwd"`` (``gemm_wgmma.cu``'s alone, at the widths of
    :func:`~vit_tpu_torch.ops._shared.ln_bwd_fused`) launches
    ``vit_gemm_ln_bwd``.  ``gemm_wgmma.launches`` counts the launches."""
    if layout not in _LAYOUTS or epilogue not in _LAYOUTS[layout][1]:
        raise ValueError(f"gemm_wgmma: no epilogue {epilogue!r} over layout {layout!r} (nk: "
                         f"{tuple(GEMM_EPILOGUES)}, kn: {tuple(DGRAD_EPILOGUES)})")
    if kernel not in GEMM_KERNELS or (epilogue == "ln_bwd" and kernel != "wgmma"):
        raise ValueError(f"gemm_wgmma: no kernel {kernel!r} for {epilogue!r} "
                         f"({tuple(GEMM_KERNELS)}; ln_bwd: wgmma)")
    if a.device.type == "cpu":
        return gemm_reference(a, w, epilogue, bias, res, h, layout, x, gamma, dy, eps)
    if epilogue == "ln_bwd":
        return _launch_gemm_ln_bwd(a, w, x, gamma, dy, eps)
    rows, k = a.shape
    n = w.shape[0] if layout == "nk" else w.shape[1]
    _check_widths("gemm_wgmma", k, n)
    operands = {"w": (w, (n, k) if layout == "nk" else (k, n))}
    if epilogue in ("bias_gelu", "bias_residual", "bias_gelu_save"):
        operands["bias"] = (bias, (n,))
    if epilogue == "bias_residual":
        operands["res"] = (res, (rows, n))
    if epilogue == "dgelu":
        operands["h"] = (h, (rows, n))
    check_kernel_tensors("gemm_wgmma", a, operands)
    out = torch.empty((rows, n), dtype=torch.float32 if epilogue == "f32" else a.dtype,
                      device=a.device)
    aux = torch.empty((rows, n), dtype=a.dtype, device=a.device) \
        if epilogue in ("bias_gelu_save", "dgelu") else None
    lib = _build.load()
    partial = sums = None
    if epilogue == "dgelu":
        partial, sums = _f32((lib.vit_linear_partial_rows(rows), n), a), _f32(n, a)
    code, epilogues = _LAYOUTS[layout]
    with torch.cuda.device(a.device):
        err = lib.vit_gemm(
            a.data_ptr(), w.data_ptr(), code,
            *(t.data_ptr() if t is not None else None
              for t in (bias, res, h, out, aux, partial, sums)),
            rows, n, k, epilogues[epilogue], GEMM_KERNELS[kernel],
            _build.DTYPE_CODES[a.dtype], launch_stream(a))
    _build.check(err, "vit_gemm")
    gemm_wgmma.launches += 1
    return (out, aux, sums) if epilogue == "dgelu" else (out, aux)


gemm_wgmma.launches = 0


def _launch_gemm_ln_bwd(a, w, x, gamma, dy, eps):
    """``vit_gemm_ln_bwd`` on CUDA tensors: ``(dx, dgamma, dbeta, dsum)`` of
    the LayerNorm-backward dgrad.  Counts ``gemm_wgmma.launches``."""
    rows, k = a.shape
    d = w.shape[1]
    if not ln_bwd_fused(d):
        raise ValueError(f"gemm_wgmma: the ln_bwd epilogue takes d % 256 == 0, 256 <= d <= 2048, "
                         f"got d={d}")
    _check_widths("gemm_wgmma", k, d)
    operands = {"w": (w, (k, d)), "x": (x, (rows, d)), "gamma": (gamma, (d,))}
    if dy is not None:
        operands["dy"] = (dy, (rows, d))
    check_kernel_tensors("gemm_wgmma", a, operands)
    dx = torch.empty_like(x)
    lib = _build.load()
    width = (2 if dy is None else 3) * d
    partial, sums = _f32((lib.vit_ln_bwd_partial_rows(rows), 3 * d), a), _f32(width, a)
    with torch.cuda.device(a.device):
        err = lib.vit_gemm_ln_bwd(
            a.data_ptr(), w.data_ptr(), x.data_ptr(), gamma.data_ptr(), data_ptr(dy),
            dx.data_ptr(), partial.data_ptr(), sums.data_ptr(), rows, d, k, eps,
            _build.DTYPE_CODES[a.dtype], launch_stream(a))
    _build.check(err, "vit_gemm_ln_bwd")
    gemm_wgmma.launches += 1
    parts = sums.view(-1, d).unbind(0)
    return dx, parts[0], parts[1], parts[2] if dy is not None else None


# ---- ln_gemm: out = (LN(x)·γ + β)·Wᵀ ------------------------------------------------------


def ln_gemm_forward_reference(x, gamma, beta, w, eps: float = 1e-3):
    """Plain PyTorch version of the forward: ``(out, xn)`` over ``(t, d)``
    rows, ``w`` ``(n_out, d)``, with the kernels' rounding points."""
    x32 = x.float()
    mu, rstd = ln_stats(x32, eps)
    xn = ((x32 - mu) * rstd * gamma.float() + beta.float()).to(x.dtype)
    return (xn.float() @ w.float().t()).to(x.dtype), xn


def ln_gemm_backward_reference(dout, x, gamma, w, eps: float = 1e-3):
    """Plain PyTorch version of the backward (``_ln_gemm_bwd_kernel``):
    ``(dx, dgamma, dbeta)``, dx in the compute dtype, the sums in f32."""
    dx_ln, dgamma, dbeta = ln_backward_reference(x.float(), dout.float() @ w.float(),
                                                 gamma.float(), eps)
    return dx_ln.to(dout.dtype), dgamma, dbeta


def _launch_ln_gemm(x, gamma, beta, w, eps: float):
    """``vit_ln_gemm_fwd`` on CUDA tensors: ``(out, xn)``.  Counts
    ``ln_gemm.launches``."""
    t, d = x.shape
    n_out = w.shape[0]
    _check_widths("ln_gemm", d, n_out)
    check_kernel_tensors("ln_gemm", x, {"gamma": (gamma, (d,)), "beta": (beta, (d,)),
                                        "w": (w, (n_out, d))})
    out = torch.empty((t, n_out), dtype=x.dtype, device=x.device)
    xn = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.load().vit_ln_gemm_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), out.data_ptr(),
            xn.data_ptr(), t, d, n_out, eps, _build.DTYPE_CODES[x.dtype], launch_stream(x))
    _build.check(err, "vit_ln_gemm_fwd")
    ln_gemm.launches += 1
    return out, xn


def ln_gemm_backward(dout, x, gamma, w, eps: float = 1e-3):
    """The backward: what :func:`ln_gemm_backward_reference` returns.  A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``vit_ln_gemm_bwd`` or raises.  ``ln_gemm_backward.launches`` counts the
    launches."""
    if dout.device.type == "cpu":
        return ln_gemm_backward_reference(dout, x, gamma, w, eps)
    out = _launch_ln_gemm_backward(dout, x, gamma, w, eps)
    ln_gemm_backward.launches += 1
    return out


ln_gemm_backward.launches = 0


def _launch_ln_gemm_backward(dout, x, gamma, w, eps: float):
    """``vit_ln_gemm_bwd`` on CUDA tensors: ``(dx, dgamma, dbeta)``, the
    dgrad dout·W with the LayerNorm backward as its epilogue (an f32 dxn and
    row statistics only outside :func:`~vit_tpu_torch.ops._shared.
    ln_bwd_fused`'s widths)."""
    t, d = x.shape
    n_out = w.shape[0]
    _check_widths("ln_gemm backward", d, n_out)
    check_kernel_tensors("ln_gemm backward", dout, {"x": (x, (t, d)), "gamma": (gamma, (d,)),
                                                    "w": (w, (n_out, d))})
    dx = torch.empty_like(x)
    sums = _f32(2 * d, x)
    lib = _build.load()
    dxn, stats = ln_bwd_scratch(t, d, x.device)
    part = _f32((lib.vit_ln_bwd_partial_rows(t), 3 * d), x)
    with torch.cuda.device(x.device):
        err = lib.vit_ln_gemm_bwd(
            dout.data_ptr(), x.data_ptr(), gamma.data_ptr(), w.data_ptr(), dx.data_ptr(),
            sums.data_ptr(), data_ptr(dxn), data_ptr(stats), part.data_ptr(), t, d, n_out, eps,
            _build.DTYPE_CODES[x.dtype], launch_stream(x))
    _build.check(err, "vit_ln_gemm_bwd")
    dgamma, dbeta = sums.view(2, d).unbind(0)
    return dx, dgamma, dbeta


def _joined(douts):
    """The ``(t, nsplit·cols)`` gradient whose column blocks are ``douts``:
    their buffer as it lies where they are its consecutive column views (as
    :func:`attention_nb`'s backward writes dq, dk and dv), else a
    concatenation."""
    first = douts[0]
    t, cols = first.shape
    width = cols * len(douts)
    if all(g.dtype == first.dtype and g.device == first.device and g.shape == first.shape
           and g.stride() == (width, 1)
           and g.data_ptr() == first.data_ptr() + i * cols * g.element_size()
           for i, g in enumerate(douts)):
        return first.as_strided((t, width), (width, 1))
    return torch.cat(douts, -1)


def _rows(t):
    """``t``'s rows: a ``(t, width)`` view of ``(..., width)``."""
    return t.reshape(-1, t.shape[-1])


def _ln_gemm_rows(x, gamma, beta, w, eps: float):
    """``(out, xn)`` over x's rows, ``out`` shaped ``(..., n_out)`` as x."""
    fn = ln_gemm_forward_reference if x.device.type == "cpu" else _launch_ln_gemm
    out, xn = fn(_rows(x), gamma, beta, w, eps)
    return out.view(*x.shape[:-1], -1), xn


class LnGemmFunction(torch.autograd.Function):
    """``ln_gemm`` under autograd (``_ln_gemm_vjp_fwd`` / ``_vjp_bwd``): the
    training forward keeps ``x`` and ``xn``; the backward runs
    :func:`ln_gemm_backward` on the joined gradient, then ``dW = doutᵀ·xn``
    as a plain GEMM.  ``gamma``/``beta`` are rounded to x's dtype for the
    kernel; their gradients come back in their own dtype."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, eps, nsplit):
        gc, bc = gamma.to(x.dtype), beta.to(x.dtype)
        out, xn = _ln_gemm_rows(x, gc, bc, w, eps)
        ctx.save_for_backward(x, xn, gc, w)
        ctx.eps, ctx.dtypes = eps, (gamma.dtype, beta.dtype)
        return out.chunk(nsplit, -1) if nsplit > 1 else out

    @staticmethod
    @once_differentiable
    def backward(ctx, *douts):
        x, xn, gc, w = ctx.saved_tensors
        douts = [_rows(g) for g in douts]
        dout = _joined(douts) if len(douts) > 1 else douts[0].contiguous()
        dx, dgamma, dbeta = ln_gemm_backward(dout, _rows(x), gc, w, ctx.eps)
        return (dx.view(x.shape), dgamma.to(ctx.dtypes[0]), dbeta.to(ctx.dtypes[1]),
                weight_grad(dout, xn), None, None)


def ln_gemm(x, gamma, beta, w, eps: float = 1e-3, nsplit: int = 1):
    """``(LN(x)·γ + β)·Wᵀ`` over ``(..., d)`` rows (``vit_tpu``'s takes ``(t,
    d)``; the layer passes ``(n, b, d)``), ``w`` the ``(n_out, d)``
    ``nn.Linear`` weight in x's dtype; with ``nsplit > 1`` the output's
    ``nsplit`` equal column blocks (q|k|v), views of one ``(..., n_out)``
    tensor.  ``gamma``/``beta`` may be f32 master parameters.  On CUDA it
    launches the kernels (bf16 or f16, widths multiples of 8) or raises; on
    the CPU it runs the plain versions.  ``ln_gemm.launches`` counts forward
    launches."""
    if w.shape[0] % nsplit:
        raise ValueError(f"ln_gemm: {w.shape[0]} output columns do not split {nsplit} ways")
    if needs_grad(x, gamma, beta, w):
        return LnGemmFunction.apply(x, gamma, beta, w, eps, nsplit)
    out = ln_gemm_op(x, gamma.to(x.dtype), beta.to(x.dtype), w, eps)
    return out.chunk(nsplit, -1) if nsplit > 1 else out


ln_gemm.launches = 0


# The serving forwards as registered ops, which torch.export keeps as one node
# each: on CUDA the kernels (counted), on the CPU the plain versions.

@torch.library.custom_op("vit_tpu_torch::ln_gemm", mutates_args=(),
                         device_types=("cuda", "cpu"))
def ln_gemm_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, w: torch.Tensor,
               eps: float) -> torch.Tensor:
    return _ln_gemm_rows(x, gamma, beta, w, eps)[0]


@ln_gemm_op.register_fake
def _(x, gamma, beta, w, eps):
    return x.new_empty(x.shape[:-1] + w.shape[:1])


# ---- attention_nb: attention over (n, b, heads·dh) rows -------------------------------------


def _nb_scale(dim_head, scale):
    return dim_head ** -0.5 if scale is None else scale


def _check_heads(q, heads, dim_head):
    if q.shape[-1] != heads * dim_head:
        raise ValueError(f"attention_nb: width {q.shape[-1]} is not {heads} heads of {dim_head}")


def attention_nb_forward_reference(q, k, v, heads: int, dim_head: int, scale=None):
    """Plain PyTorch version of the forward: ``(o, lse)``, o ``(n, b,
    heads·dh)`` in q's dtype, lse f32 ``(b, heads, n)``."""
    out, lse = short_attention_forward_reference(nb_heads(q, heads), nb_heads(k, heads),
                                                 nb_heads(v, heads), _nb_scale(dim_head, scale))
    return nb_merge(out), lse


def attention_nb_backward_reference(do, q, k, v, o, lse, heads: int, dim_head: int, scale=None):
    """Plain PyTorch version of the backward: ``(dq, dk, dv)``, each ``(n, b,
    heads·dh)``."""
    grads = short_attention_backward_reference(
        *(nb_heads(t, heads) for t in (q, k, v, o)), lse, nb_heads(do, heads),
        _nb_scale(dim_head, scale))
    return tuple(nb_merge(g) for g in grads)


def attention_nb_backward(do, q, k, v, o, lse, heads: int, dim_head: int, scale=None):
    """The backward kernel over ``(n, b, heads·dh)`` rows: ``(dq, dk, dv)``,
    views of one ``(n, b, 3·heads·dh)`` buffer.  A CPU tensor takes the plain
    version; a CUDA tensor launches ``vit_short_attention_bwd`` or raises.
    ``attention_nb_backward.launches`` counts the launches."""
    _check_heads(q, heads, dim_head)
    return short_attention_backward_nb(q, k, v, nb_heads(o, heads), lse, do, heads,
                                       _nb_scale(dim_head, scale), attention_nb_backward)


attention_nb_backward.launches = 0


def attention_nb_forward(q, k, v, heads: int, dim_head: int, scale=None, need_lse: bool = True):
    """The forward kernel: ``(o, lse)`` as
    :func:`attention_nb_forward_reference` returns them (lse None unless
    ``need_lse``).  A CPU tensor takes the plain version; a CUDA tensor
    launches ``vit_short_attention_fwd`` or raises.  Counts
    ``attention_nb.launches``."""
    _check_heads(q, heads, dim_head)
    out, lse = short_attention_forward(*(nb_heads(t, heads) for t in (q, k, v)),
                                       _nb_scale(dim_head, scale), need_lse=need_lse,
                                       layout="nb", counter=attention_nb)
    return nb_merge(out), lse


def attention_nb(q, k, v, heads: int, dim_head: int, scale=None):
    """Multi-head attention over q, k, v in the ``(n, b, heads·dh)`` layout
    (strided views allowed: the last axis contiguous, the others multiples
    of 8 elements); returns ``(n, b, heads·dh)`` in q's dtype.  ``scale``
    defaults to ``dim_head ** -0.5``.  Differentiable through
    :class:`~vit_tpu_torch.ops.short_attention.ShortAttentionFunction`, whose
    backward writes dq, dk, dv into one ``(n, b, 3·heads·dh)`` buffer.  On
    CUDA it takes n ≤ 512 and dim_head ∈ {32, 64, 128} in bf16 or f16 and
    raises on anything else.  ``attention_nb.launches`` counts forward
    launches."""
    if not needs_grad(q, k, v):
        return attention_nb_op(q, k, v, heads, dim_head, float(_nb_scale(dim_head, scale)))
    _check_heads(q, heads, dim_head)
    return ShortAttentionFunction.apply(q, k, v, _nb_scale(dim_head, scale), heads,
                                        (attention_nb, attention_nb_backward))


attention_nb.launches = 0


@torch.library.custom_op("vit_tpu_torch::attention_nb", mutates_args=(),
                         device_types=("cuda", "cpu"))
def attention_nb_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                    dim_head: int, scale: float) -> torch.Tensor:
    return attention_nb_forward(q, k, v, heads, dim_head, scale, need_lse=False)[0]


@attention_nb_op.register_fake
def _(q, k, v, heads, dim_head, scale):
    return q.new_empty(q.shape[:-1] + v.shape[-1:])


# ---- proj_mlp: y = x + o·Woᵀ + bo;  z = y + fc2(gelu(fc1(LN(y)))) --------------------------


def proj_mlp_forward_reference(x, o, wo, bo, gamma, beta, w1, b1, w2, b2, eps: float = 1e-3):
    """Plain PyTorch version of the training forward: ``(z, y, xn, h)`` over
    ``(t, ·)`` rows with the kernels' rounding points; weights in
    ``nn.Linear`` layout."""
    y = x + F.linear(o.float(), wo.float(), bo.float()).to(x.dtype)
    z, xn, h = fused_mlp_forward_reference(y, gamma, beta, w1, b1, w2, b2, eps)
    return z, y, xn, h


def proj_mlp_backward_reference(dz, y, h, gamma, wo, w1, w2, eps: float = 1e-3):
    """Plain PyTorch version of the backward (``_proj_mlp_bwd_kernel``):
    ``(dy, do, dh, gact, dgamma, dbeta, dbo, db1, db2)``, the first four in
    the compute dtype, the sums in f32."""
    dy, dh, gact, dgamma, dbeta, db1, db2 = fused_mlp_backward_reference(dz, y, h, gamma, w1, w2,
                                                                         eps)
    do = (dy.float() @ wo.float()).to(dy.dtype)
    return dy, do, dh, gact, dgamma, dbeta, dy.float().sum(0), db1, db2


def _proj_mlp_buffers(x, hidden: int, save_residuals: bool):
    """The outputs and scratch of ``vit_proj_mlp_fwd`` over x's ``(t, d)``
    rows: ``(z, y, xn, g, h)``, each contiguous (the forward GEMMs read xn and
    g through 2-d tensor maps whose rows lie their width apart), ``h`` None
    unless ``save_residuals``."""
    z, y, xn = torch.empty_like(x), torch.empty_like(x), torch.empty_like(x)
    g = torch.empty((x.shape[0], hidden), dtype=x.dtype, device=x.device)
    return z, y, xn, g, torch.empty_like(g) if save_residuals else None


def _launch_proj_mlp(x, o, wo, bo, gamma, beta, w1, b1, w2, b2, eps: float,
                     save_residuals: bool):
    """``vit_proj_mlp_fwd`` on CUDA tensors: ``(z, y, xn, h)``, with ``xn``
    and ``h`` None unless ``save_residuals``.  Counts ``proj_mlp.launches``."""
    t, d = x.shape
    inner, hidden = o.shape[-1], w1.shape[0]
    _check_widths("proj_mlp", d, inner, hidden)
    check_kernel_tensors("proj_mlp", x, {
        "o": (o, (t, inner)), "wo": (wo, (d, inner)), "bo": (bo, (d,)),
        "gamma": (gamma, (d,)), "beta": (beta, (d,)), "w1": (w1, (hidden, d)),
        "b1": (b1, (hidden,)), "w2": (w2, (d, hidden)), "b2": (b2, (d,))})
    z, y, xn, g, h = _proj_mlp_buffers(x, hidden, save_residuals)
    with torch.cuda.device(x.device):
        err = _build.load().vit_proj_mlp_fwd(
            x.data_ptr(), o.data_ptr(), wo.data_ptr(), bo.data_ptr(), gamma.data_ptr(),
            beta.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            z.data_ptr(), y.data_ptr(), xn.data_ptr(), g.data_ptr(),
            h.data_ptr() if save_residuals else None, t, d, inner, hidden, eps,
            _build.DTYPE_CODES[x.dtype], launch_stream(x))
    _build.check(err, "vit_proj_mlp_fwd")
    proj_mlp.launches += 1
    return (z, y, xn, h) if save_residuals else (z, y, None, None)


def proj_mlp_backward(dz, y, h, gamma, wo, w1, w2, eps: float = 1e-3):
    """The backward: what :func:`proj_mlp_backward_reference` returns.  A CPU
    tensor takes the plain version; a CUDA tensor launches
    ``vit_proj_mlp_bwd`` or raises.  ``proj_mlp_backward.launches`` counts
    the launches."""
    if dz.device.type == "cpu":
        return proj_mlp_backward_reference(dz, y, h, gamma, wo, w1, w2, eps)
    return _launch_proj_mlp_backward(dz, y, h, gamma, wo, w1, w2, eps)


def _launch_proj_mlp_backward(dz, y, h, gamma, wo, w1, w2, eps):
    """``vit_proj_mlp_bwd`` on CUDA tensors: its three dgrads (dz·W2 with the
    dGELU epilogue and db1's partials, dh·W1 into f32, dy·Wo) read each
    weight as it lies, ``(k, n)`` with n contiguous."""
    t, d = dz.shape
    inner, hidden = wo.shape[1], w1.shape[0]
    _check_widths("proj_mlp backward", d, inner, hidden)
    check_kernel_tensors("proj_mlp backward", dz, {
        "y": (y, (t, d)), "h": (h, (t, hidden)), "gamma": (gamma, (d,)),
        "wo": (wo, (d, inner)), "w1": (w1, (hidden, d)), "w2": (w2, (d, hidden))})
    dy = torch.empty_like(dz)
    do = torch.empty((t, inner), dtype=dz.dtype, device=dz.device)
    dh, gact = torch.empty_like(h), torch.empty_like(h)
    sums_h, sums_d, dbo = _f32(hidden, dz), _f32(3 * d, dz), _f32(d, dz)
    lib = _build.load()
    dxn, stats = ln_bwd_scratch(t, d, dz.device)
    part_h = _f32((lib.vit_linear_partial_rows(t), hidden), dz)
    part_d = _f32((lib.vit_ln_bwd_partial_rows(t), 3 * d), dz)
    with torch.cuda.device(dz.device):
        err = lib.vit_proj_mlp_bwd(
            dz.data_ptr(), y.data_ptr(), h.data_ptr(), gamma.data_ptr(), wo.data_ptr(),
            w1.data_ptr(), w2.data_ptr(), dy.data_ptr(), do.data_ptr(), dh.data_ptr(),
            gact.data_ptr(), sums_h.data_ptr(), sums_d.data_ptr(), dbo.data_ptr(),
            data_ptr(dxn), data_ptr(stats), part_h.data_ptr(), part_d.data_ptr(), t, d, inner,
            hidden, eps, _build.DTYPE_CODES[dz.dtype], launch_stream(dz))
    _build.check(err, "vit_proj_mlp_bwd")
    proj_mlp_backward.launches += 1
    dgamma, dbeta, db2 = sums_d.view(3, d).unbind(0)
    return dy, do, dh, gact, dgamma, dbeta, dbo, sums_h, db2


proj_mlp_backward.launches = 0


def _proj_mlp_rows(x, o, *params, save_residuals: bool):
    """``(z, y, xn, h)`` over the rows of x and o, ``z`` shaped as x; y,
    xn and h (None unless ``save_residuals``, on CUDA) over rows."""
    args = (_rows(x), _rows(o), *params)
    if x.device.type == "cpu":
        z, y, xn, h = proj_mlp_forward_reference(*args)
    else:
        z, y, xn, h = _launch_proj_mlp(*args, save_residuals=save_residuals)
    return z.view(x.shape), y, xn, h


class ProjMLPFunction(torch.autograd.Function):
    """``proj_mlp`` under autograd (``_proj_mlp_vjp_fwd`` / ``_vjp_bwd``):
    the training forward keeps ``o``, ``y``, ``xn`` and ``h``; the backward
    runs :func:`proj_mlp_backward`, then ``dWo = dyᵀ·o``, ``dW1 = dhᵀ·xn``
    and ``dW2 = dzᵀ·gact`` as plain GEMMs.  ``gamma``/``beta`` are rounded
    to x's dtype for the kernel; every parameter gradient comes back in its
    parameter's dtype."""

    @staticmethod
    def forward(ctx, x, o, wo, bo, gamma, beta, w1, b1, w2, b2, eps):
        gc, bc = gamma.to(x.dtype), beta.to(x.dtype)
        z, y, xn, h = _proj_mlp_rows(x, o, wo, bo, gc, bc, w1, b1, w2, b2, eps,
                                     save_residuals=True)
        ctx.save_for_backward(o, y, xn, h, gc, wo, w1, w2)
        ctx.eps, ctx.x_shape = eps, x.shape
        ctx.dtypes = tuple(p.dtype for p in (bo, gamma, beta, b1, b2))
        return z

    @staticmethod
    @once_differentiable
    def backward(ctx, dz):
        o, y, xn, h, gc, wo, w1, w2 = ctx.saved_tensors
        dz = _rows(dz).contiguous()
        dy, do, dh, gact, dgamma, dbeta, dbo, db1, db2 = proj_mlp_backward(
            dz, y, h, gc, wo, w1, w2, ctx.eps)
        bo_dt, gamma_dt, beta_dt, b1_dt, b2_dt = ctx.dtypes
        return (dy.view(ctx.x_shape), do.view(o.shape), weight_grad(dy, o), dbo.to(bo_dt),
                dgamma.to(gamma_dt), dbeta.to(beta_dt), weight_grad(dh, xn), db1.to(b1_dt),
                weight_grad(dz, gact), db2.to(b2_dt), None)


def proj_mlp(x, o, wo, bo, gamma, beta, w1, b1, w2, b2, eps: float = 1e-3):
    """The attention's out-projection and residual, then the pre-norm MLP and
    its residual, over ``(..., d)`` rows (``vit_tpu``'s takes ``(t, d)``):
    ``y = x + o·Woᵀ + bo``, ``z = y + fc2(gelu(fc1(LN(y))))``.  ``o``
    ``(..., inner)`` over the same rows; weights in ``nn.Linear``
    layout and x's dtype; ``gamma``/``beta`` may be f32 master parameters.
    On CUDA it launches the kernels (bf16 or f16, widths multiples of 8) or
    raises; on the CPU it runs the plain versions.  ``proj_mlp.launches``
    counts forward launches."""
    if needs_grad(x, o, wo, bo, gamma, beta, w1, b1, w2, b2):
        return ProjMLPFunction.apply(x, o, wo, bo, gamma, beta, w1, b1, w2, b2, eps)
    return proj_mlp_op(x, o, wo, bo, gamma.to(x.dtype), beta.to(x.dtype), w1, b1, w2, b2, eps)


proj_mlp.launches = 0


@torch.library.custom_op("vit_tpu_torch::proj_mlp", mutates_args=(),
                         device_types=("cuda", "cpu"))
def proj_mlp_op(x: torch.Tensor, o: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                gamma: torch.Tensor, beta: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                w2: torch.Tensor, b2: torch.Tensor, eps: float) -> torch.Tensor:
    return _proj_mlp_rows(x, o, wo, bo, gamma, beta, w1, b1, w2, b2, eps,
                          save_residuals=False)[0]


@proj_mlp_op.register_fake
def _(x, *args):
    return x.new_empty(x.shape)
