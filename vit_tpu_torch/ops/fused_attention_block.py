"""Fused pre-norm attention block: ``x + out_proj(attn(qkv(LN(x))))``.

Port of ``vit_tpu/ops/fused_attention_block.py::fused_attention_block`` (the
TPU kernel ``_fwd_kernel``, driven by ``_forward``).  On a CUDA tensor
:func:`fused_attention_block` launches the hand-written kernels of
``vit_tpu_torch/csrc/fused_attention_block.cu``; on a CPU tensor it runs
:func:`fused_attention_block_reference`, the plain PyTorch version.

What bounds it on the H100: at ViT-B/16, batch 64 (12,608 rows, d=768,
12 heads of 64) the QKV and output GEMMs are about 59 GFLOP per block and the
attention products about 15 GFLOP, all far above the card's FLOP-per-byte
ridge, so the tensor cores bound it.  The design reads q/k/v strided out of
the packed projection (no head-split transpose), keeps the n×n probabilities
in registers with an online softmax, fuses bias and residual into the
out-projection epilogue, and runs the LayerNorm as a small memory-bound pass.

Numerics, mirrored by the plain version: f32 LayerNorm statistics (biased
two-pass variance), xn rounded to the compute dtype; qkv rounded before the
attention; logits in f32, ``scale`` applied to the f32 logits; the
probabilities rounded to the compute dtype for P·V and divided by the f32 row
sum afterwards (late divide); the attention output rounded before the
out-projection; the residual adds in the compute dtype.  The TPU padded odd
token counts on the host and masked with -1e30; the CUDA kernel masks ragged
keys itself with -inf.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import (
    check_kernel_tensors, forbid_grad, launch_stream,
)

SUPPORTED_DIM_HEAD = (32, 64, 128)


def fused_attention_block_reference(x, gamma, beta, wqkv, wo, bo, heads: int,
                                    dim_head: int, scale: float | None = None,
                                    eps: float = 1e-3):
    """Plain PyTorch version of the kernel, same rounding points.

    ``x``: ``(b, n, d)``; ``wqkv``: ``(3·heads·dim_head, d)`` with q|k|v
    thirds and head ``h`` at rows ``h·dim_head…``; ``wo``:
    ``(d, heads·dim_head)``; ``bo``: ``(d,)`` (``nn.Linear`` layout).
    """
    if scale is None:
        scale = dim_head ** -0.5
    dt = x.dtype
    b, n, _ = x.shape
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    xn = ((x32 - mu) * torch.rsqrt(var + eps) * gamma.float()
          + beta.float()).to(dt)
    qkv = F.linear(xn.float(), wqkv.float()).to(dt)
    q, k, v = (t.reshape(b, n, heads, dim_head).transpose(1, 2).float()
               for t in qkv.chunk(3, dim=-1))
    s = (q @ k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    o = (e.to(dt).float() @ v) / e.sum(-1, keepdim=True)
    oattn = o.to(dt).transpose(1, 2).reshape(b, n, heads * dim_head)
    y = F.linear(oattn.float(), wo.float(), bo.float())
    return x + y.to(dt)


def fused_attention_block_supported(d: int, heads: int, dim_head: int) -> bool:
    """Whether the kernel takes these widths: 16-byte rows and a head width
    the attention kernel is instantiated for."""
    return d % 8 == 0 and heads >= 1 and dim_head in SUPPORTED_DIM_HEAD


def fused_attention_block(x, gamma, beta, wqkv, wo, bo, heads: int,
                          dim_head: int, scale: float | None = None,
                          eps: float = 1e-3):
    """``x + (softmax(q·kᵀ·scale)·v)·Woᵀ + bo`` with ``q,k,v = LN(x)·Wqkvᵀ``.

    ``x`` is ``(b, n, d)``; weights as in
    :func:`fused_attention_block_reference`; on CUDA every parameter,
    ``gamma`` and ``beta`` included, is in ``x``'s dtype (bf16 or f16), as the
    TPU wrapper rounded them.  A CPU tensor takes the plain version.  A CUDA tensor launches the kernels or raises; forward only
    (``NotImplementedError`` if autograd would need a backward).
    ``fused_attention_block.launches`` counts kernel launches.
    """
    if scale is None:
        scale = dim_head ** -0.5
    if x.device.type == "cpu":
        return fused_attention_block_reference(x, gamma, beta, wqkv, wo, bo,
                                               heads, dim_head, scale, eps)
    forbid_grad("fused_attention_block", x, gamma, beta, wqkv, wo, bo)
    if x.dim() != 3:
        raise ValueError(f"fused_attention_block: x must be (b, n, d), got "
                         f"{tuple(x.shape)}")
    b, n, d = x.shape
    inner = heads * dim_head
    if not fused_attention_block_supported(d, heads, dim_head):
        raise ValueError(
            f"fused_attention_block kernel needs d % 8 == 0 and dim_head in "
            f"{SUPPORTED_DIM_HEAD}, got d={d}, heads={heads}, "
            f"dim_head={dim_head}")
    check_kernel_tensors("fused_attention_block", x, {
        "gamma": (gamma, (d,)), "beta": (beta, (d,)),
        "wqkv": (wqkv, (3 * inner, d)), "wo": (wo, (d, inner)),
        "bo": (bo, (d,)),
    })
    rows = b * n
    y = torch.empty_like(x)
    xn = torch.empty_like(x)
    qkv = torch.empty((rows, 3 * inner), dtype=x.dtype, device=x.device)
    oattn = torch.empty((rows, inner), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.vit_fused_attention_block_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
            wo.data_ptr(), bo.data_ptr(), y.data_ptr(), xn.data_ptr(),
            qkv.data_ptr(), oattn.data_ptr(), b, n, d, heads, dim_head,
            float(scale), eps,
            _build.DTYPE_CODES[x.dtype],
            launch_stream(x))
    _build.check(err, "vit_fused_attention_block_fwd")
    fused_attention_block.launches += 1
    return y


fused_attention_block.launches = 0
