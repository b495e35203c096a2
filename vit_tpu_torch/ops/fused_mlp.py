"""Fused transformer MLP block: ``x + fc2(gelu(fc1(LN(x))))``.

Port of ``vit_tpu/ops/fused_mlp.py::fused_mlp`` / ``fused_mlp_3d`` (the TPU
kernel ``_fwd_kernel``, driven by ``_forward`` / ``_forward3``).  On a CUDA
tensor :func:`fused_mlp` launches the hand-written kernel of
``vit_tpu_torch/csrc/fused_mlp.cu``; on a CPU tensor it runs
:func:`fused_mlp_reference`, the plain PyTorch version of the same math.

What bounds it on the H100: at ViT-B/16, batch 64, the block is two GEMMs
over 12,608 rows of d=768 with h=3072 (about 119 GFLOP against tens of MB of
activations and weights), so it is compute-bound on the tensor cores.  The
kernel therefore spends its design on the GEMMs (mma.sync with f32
accumulation), fuses the bias, GELU and residual into the epilogues, and runs
the LayerNorm as a small memory-bound pass; the extra traffic is xn and the
hidden activation h in device memory (see the source note in the .cu).

Numerics, mirrored by the plain version: LayerNorm statistics in f32 with the
biased two-pass variance and eps inside the rsqrt; xn rounded to the compute
dtype before fc1; f32 accumulation; exact-erf GELU in f32, rounded before fc2;
the residual adds in the compute dtype.  The TPU's production path used the
tanh GELU because Mosaic has no erf; CUDA has ``erff``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import (
    check_kernel_tensors, forbid_grad, launch_stream,
)


def fused_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-3):
    """Plain PyTorch version of the kernel, same rounding points.

    ``x``: ``(t, d)`` or ``(b, n, d)``; ``gamma``/``beta``: ``(d,)``;
    ``w1``: ``(h, d)``, ``b1``: ``(h,)``, ``w2``: ``(d, h)``, ``b2``: ``(d,)``
    (``nn.Linear`` layout).  GEMMs run in f32 on the compute-dtype values.
    """
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = (x32 - mu).square().mean(-1, keepdim=True)
    xn = ((x32 - mu) * torch.rsqrt(var + eps) * gamma.float()
          + beta.float()).to(dt)
    h32 = F.linear(xn.float(), w1.float(), b1.float())
    g = F.gelu(h32).to(dt)
    o32 = F.linear(g.float(), w2.float(), b2.float())
    return x + o32.to(dt)


def fused_mlp_supported(d: int, hidden: int) -> bool:
    """Whether the kernel takes these widths (16-byte rows: multiples of 8)."""
    return d % 8 == 0 and hidden % 8 == 0


def fused_mlp(x, gamma, beta, w1, b1, w2, b2, eps: float = 1e-3):
    """``x + fc2(gelu(fc1(LN(x))))`` over ``(t, d)`` or ``(b, n, d)`` rows.

    Weights in ``nn.Linear`` layout; on CUDA every parameter, ``gamma`` and
    ``beta`` included, is in ``x``'s dtype (bf16 or f16), as the TPU wrapper
    rounded them.  A CPU tensor takes :func:`fused_mlp_reference`.  A CUDA tensor launches the kernel or
    raises; forward only (``NotImplementedError`` if autograd would need a
    backward).  ``fused_mlp.launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return fused_mlp_reference(x, gamma, beta, w1, b1, w2, b2, eps)
    d = x.shape[-1]
    hidden = w1.shape[0]
    forbid_grad("fused_mlp", x, gamma, beta, w1, b1, w2, b2)
    if not fused_mlp_supported(d, hidden):
        raise ValueError(
            f"fused_mlp kernel needs d and hidden to be multiples of 8, got "
            f"d={d}, hidden={hidden}")
    check_kernel_tensors("fused_mlp", x, {
        "gamma": (gamma, (d,)), "beta": (beta, (d,)),
        "w1": (w1, (hidden, d)), "b1": (b1, (hidden,)),
        "w2": (w2, (d, hidden)), "b2": (b2, (d,)),
    })
    rows = x.numel() // d
    y = torch.empty_like(x)
    xn = torch.empty_like(x)
    h = torch.empty((rows, hidden), dtype=x.dtype, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.vit_fused_mlp_fwd(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
            xn.data_ptr(), h.data_ptr(), rows, d, hidden, eps,
            _build.DTYPE_CODES[x.dtype],
            launch_stream(x))
    _build.check(err, "vit_fused_mlp_fwd")
    fused_mlp.launches += 1
    return y


fused_mlp.launches = 0
