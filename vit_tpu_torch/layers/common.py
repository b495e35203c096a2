"""Shared transformer primitives (port of the slice of
``vit_tpu/layers/common.py`` that ViT needs).

Numerics follow ``vit_tpu`` (and through it the TF reference): exact-erf GELU,
LayerNorm with eps 1e-3 and biased two-pass variance, glorot-uniform Dense
kernels with zero biases.

Kernel dispatch (``fused_attention`` / ``fused_mlp``): ``"auto"`` sends every
call of a CUDA 16-bit module in eval mode to the hand-written CUDA block
kernels, at every sequence length.  It never swaps in the plain modules there:
widths the kernels do not take raise ``ValueError``, and a call that autograd
would have to differentiate raises ``NotImplementedError`` (the backward
kernels are not ported yet; run under ``torch.inference_mode()``).  CPU
tensors, f32 modules and training mode run the plain modules, as does an
attention without an output projection (``heads == 1`` and
``dim_head == dim``), which is not the block the kernel computes, as in
``vit_tpu``.  ``"never"`` always runs the plain modules.  The TPU package's
``"interpret"``, ``"hybrid"`` and ``"bmajor"`` modes were TPU dispatch tiers
and are refused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.ops._checks import KERNEL_DTYPES
from vit_tpu_torch.ops.attention import scaled_dot_product_attention
from vit_tpu_torch.ops.fused_attention_block import fused_attention_block
from vit_tpu_torch.ops.fused_mlp import fused_mlp

FUSED_MODES = ("auto", "never")
_TPU_ONLY_MODES = {
    "interpret": "ran the Pallas kernels in the TPU interpreter for CPU tests "
                 "(the port's CPU path is the kernels' plain PyTorch versions)",
    "hybrid": "opted into the TPU's batch-in-sublane (n, b, d) short-sequence "
              "tier (vit_tpu/ops/fused_hybrid.py)",
    "bmajor": "forced the TPU's token-major block kernels outside their "
              "measured 128 <= n <= 1024 window",
}


def check_fused_mode(name: str, mode: str) -> str:
    """Validate a ``fused_attention`` / ``fused_mlp`` mode."""
    if mode in _TPU_ONLY_MODES:
        raise ValueError(
            f"{name}={mode!r} is a TPU-only mode: it {_TPU_ONLY_MODES[mode]}. "
            f"The CUDA port takes {FUSED_MODES}.")
    if mode not in FUSED_MODES:
        raise ValueError(f"{name} must be one of {FUSED_MODES}, got {mode!r}")
    return mode


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """0.5·x·(1+erf(x/√2)) — reference vit.py:34."""
    return F.gelu(x, approximate="none")


def glorot_linear_(linear: nn.Linear, generator: torch.Generator | None = None) -> nn.Linear:
    """Keras-parity Dense init: glorot-uniform weight, zero bias."""
    with torch.no_grad():
        nn.init.xavier_uniform_(linear.weight, generator=generator)
        if linear.bias is not None:
            linear.bias.zero_()
    return linear


def _linear(d_in, d_out, bias, device, dtype, generator):
    return glorot_linear_(nn.Linear(d_in, d_out, bias=bias, device=device, dtype=dtype),
                          generator)


class LayerNorm(nn.Module):
    """Keras-parity LayerNorm: eps 1e-3, biased two-pass variance, statistics
    and normalisation in f32, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-3, *, device=None, dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + self.eps) * self.weight.float() \
            + self.bias.float()
        return y.to(x.dtype)


class MLP(nn.Module):
    """Dense→GELU→Dropout→Dense→Dropout (reference vit.py:24-47)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.fc1 = _linear(dim, hidden_dim, True, device, dtype, generator)
        self.fc2 = _linear(hidden_dim, dim, True, device, dtype, generator)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(gelu_exact(self.fc1(x)))
        return self.dropout(self.fc2(x))


class Attention(nn.Module):
    """Multi-head self-attention (reference vit.py:49-85): fused qkv
    projection without bias, output projection + dropout unless single-head
    with ``dim_head == dim``."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, *, device=None, dtype=None, generator=None):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.project_out = not (heads == 1 and dim_head == dim)
        self.to_qkv = _linear(dim, inner * 3, False, device, dtype, generator)
        if self.project_out:
            self.to_out = nn.Sequential(
                _linear(inner, dim, True, device, dtype, generator), nn.Dropout(dropout))
        else:
            self.to_out = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.to_qkv(x).chunk(3, dim=-1))
        out = scaled_dot_product_attention(q, k, v, scale=self.dim_head ** -0.5)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        return self.to_out(out)


def _kernels_apply(x: torch.Tensor, *modules: nn.Module) -> bool:
    """Whether ``"auto"`` sends this call to the CUDA block kernels: a 16-bit
    CUDA activation and modules in eval mode.  The kernel wrappers then check
    the widths and the grad mode, and raise rather than run the plain path;
    training keeps the plain modules until the backward kernels are ported."""
    return (x.is_cuda and x.dtype in KERNEL_DTYPES
            and not any(m.training for m in modules))


def apply_fused_mlp_block(norm: LayerNorm, mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """``x + mlp(norm(x))`` through the fused MLP kernel, from the
    parameters of the ``LayerNorm`` / ``MLP`` pair."""
    return fused_mlp(x, norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias,
                     mlp.fc2.weight, mlp.fc2.bias, norm.eps)


def apply_fused_attention_block(norm: LayerNorm, attn: Attention,
                                x: torch.Tensor) -> torch.Tensor:
    """``x + attn(norm(x))`` through the fused attention-block kernel, from
    the parameters of the ``LayerNorm`` / ``Attention`` pair."""
    out = attn.to_out[0]
    return fused_attention_block(x, norm.weight, norm.bias, attn.to_qkv.weight,
                                 out.weight, out.bias, attn.heads, attn.dim_head,
                                 attn.dim_head ** -0.5, norm.eps)


def fused_attention_eligible(x: torch.Tensor, norm: LayerNorm, attn: Attention,
                             mode: str) -> bool:
    return mode == "auto" and attn.project_out and _kernels_apply(x, norm, attn)


def fused_mlp_eligible(x: torch.Tensor, norm: LayerNorm, mlp: MLP, mode: str) -> bool:
    return mode == "auto" and _kernels_apply(x, norm, mlp)


def fused_mlp_residual(x: torch.Tensor, norm: LayerNorm, mlp: MLP,
                       mode: str = "auto") -> torch.Tensor:
    """``x + mlp(norm(x))`` with the Transformer's fused-MLP dispatch, for
    encoders whose attention differs but whose MLP half is the standard
    pre-norm block."""
    if fused_mlp_eligible(x, norm, mlp, mode):
        return apply_fused_mlp_block(norm, mlp, x)
    return x + mlp(norm(x))


class Transformer(nn.Module):
    """Pre-norm residual encoder stack (reference vit.py:87-104).

    ``layers[i]`` holds ``attn_norm``, ``attn``, ``mlp_norm`` and ``mlp``
    (``transformer/attn_norm_{i}`` … in the Flax tree).  See the module
    docstring for the ``fused_attention`` / ``fused_mlp`` dispatch.
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0, fused_mlp: str = "auto",
                 fused_attention: str = "auto", *, device=None, dtype=None,
                 generator=None):
        super().__init__()
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        kw = dict(device=device, dtype=dtype)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "attn_norm": LayerNorm(dim, **kw),
                "attn": Attention(dim, heads, dim_head, dropout, generator=generator, **kw),
                "mlp_norm": LayerNorm(dim, **kw),
                "mlp": MLP(dim, mlp_dim, dropout, generator=generator, **kw),
            })
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            if fused_attention_eligible(x, layer["attn_norm"], layer["attn"],
                                        self.fused_attention):
                x = apply_fused_attention_block(layer["attn_norm"], layer["attn"], x)
            else:
                x = x + layer["attn"](layer["attn_norm"](x))
            x = fused_mlp_residual(x, layer["mlp_norm"], layer["mlp"], self.fused_mlp)
        return x
