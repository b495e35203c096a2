"""Shared transformer primitives (port of the slice of
``vit_tpu/layers/common.py`` that ViT needs).

Numerics follow ``vit_tpu`` (and through it the TF reference): exact-erf GELU,
LayerNorm with eps 1e-3 and biased two-pass variance, glorot-uniform Dense
kernels with zero biases.

Device and dtypes: every module builds on the card unless ``device`` asks for
another (``device=None`` is CUDA, and raises without a CUDA device).  ``dtype``
is the parameter dtype.  The modules compute in the dtype of the activation
they are given, casting their weights to it inside autograd, as ``vit_tpu``
casts f32 parameters to its compute ``dtype`` in the graph: with f32
parameters and bf16 activations the gradients still reach f32 ``.grad``.

Kernel dispatch (``fused_attention`` / ``fused_mlp``), as ``vit_tpu``'s
training gates (``_fused_attention_tier``, ``_fused_mlp_eligible``):
``"auto"`` sends a call to the hand-written CUDA block kernels, forward and
backward, when the activation is a 16-bit CUDA tensor, the attention has an
output projection, and dropout is inactive (eval mode, or a rate of 0) — in
training and under grad alike, at every sequence length.  It never swaps in
the plain modules there: widths the kernels do not take raise ``ValueError``.
CPU tensors and f32 activations run the plain modules, as do active dropout
and an attention without an output projection (``heads == 1`` and
``dim_head == dim``), which is not the block the kernel computes, as in
``vit_tpu``.  ``"never"`` always runs the plain modules.  The TPU package's
``"interpret"``, ``"hybrid"`` and ``"bmajor"`` modes were TPU dispatch tiers
and are refused.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
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


def cast_to(p: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """A parameter in ``x``'s dtype, cast inside autograd (a no-op when it
    already is), so that its gradient reaches the parameter's own dtype."""
    return None if p is None else p.to(x.dtype)


def linear(module: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` computed in ``x``'s dtype (the compute dtype)."""
    return F.linear(x, cast_to(module.weight, x), cast_to(module.bias, x))


class LayerNorm(nn.Module):
    """Keras-parity LayerNorm: eps 1e-3, biased two-pass variance, statistics
    and normalisation in f32, output in the input dtype."""

    def __init__(self, dim: int, eps: float = 1e-3, *, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
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
        device = resolve_device(device)
        self.fc1 = _linear(dim, hidden_dim, True, device, dtype, generator)
        self.fc2 = _linear(hidden_dim, dim, True, device, dtype, generator)
        self.dropout = nn.Dropout(dropout)

    @property
    def dropout_active(self) -> bool:
        return self.training and self.dropout.p > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dropout(gelu_exact(linear(self.fc1, x)))
        return self.dropout(linear(self.fc2, x))


class Attention(nn.Module):
    """Multi-head self-attention (reference vit.py:49-85): fused qkv
    projection without bias, output projection + dropout unless single-head
    with ``dim_head == dim``."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, *, device=None, dtype=None, generator=None):
        super().__init__()
        device = resolve_device(device)
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

    @property
    def dropout_active(self) -> bool:
        return self.project_out and self.training and self.to_out[1].p > 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in linear(self.to_qkv, x).chunk(3, dim=-1))
        out = scaled_dot_product_attention(q, k, v, scale=self.dim_head ** -0.5)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        if not self.project_out:
            return out
        return self.to_out[1](linear(self.to_out[0], out))


def kernel_activation(x: torch.Tensor) -> bool:
    """Whether ``x`` is an activation the CUDA block kernels take: a 16-bit
    CUDA tensor.  The kernel wrappers then check the widths, and raise rather
    than run the plain path."""
    return x.is_cuda and x.dtype in KERNEL_DTYPES


def apply_fused_mlp_block(norm: LayerNorm, mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """``x + mlp(norm(x))`` through the fused MLP kernel, from the parameters
    of the ``LayerNorm`` / ``MLP`` pair in the compute dtype (``x``'s); the
    LayerNorm's γ/β go as they are, and the op rounds them."""
    return fused_mlp(x, norm.weight, norm.bias, cast_to(mlp.fc1.weight, x),
                     cast_to(mlp.fc1.bias, x), cast_to(mlp.fc2.weight, x),
                     cast_to(mlp.fc2.bias, x), norm.eps)


def apply_fused_attention_block(norm: LayerNorm, attn: Attention,
                                x: torch.Tensor) -> torch.Tensor:
    """``x + attn(norm(x))`` through the fused attention-block kernel, from
    the parameters of the ``LayerNorm`` / ``Attention`` pair, as
    :func:`apply_fused_mlp_block`."""
    out = attn.to_out[0]
    return fused_attention_block(x, norm.weight, norm.bias, cast_to(attn.to_qkv.weight, x),
                                 cast_to(out.weight, x), cast_to(out.bias, x), attn.heads,
                                 attn.dim_head, attn.dim_head ** -0.5, norm.eps)


def fused_attention_eligible(x: torch.Tensor, attn: Attention, mode: str) -> bool:
    """``_fused_attention_tier``'s gate: an output projection and no active
    dropout, on an activation the kernels take."""
    return (mode == "auto" and attn.project_out and not attn.dropout_active
            and kernel_activation(x))


def fused_mlp_eligible(x: torch.Tensor, mlp: MLP, mode: str) -> bool:
    """``_fused_mlp_eligible``'s gate: no active dropout, on an activation the
    kernels take."""
    return mode == "auto" and not mlp.dropout_active and kernel_activation(x)


def fused_mlp_residual(x: torch.Tensor, norm: LayerNorm, mlp: MLP,
                       mode: str = "auto") -> torch.Tensor:
    """``x + mlp(norm(x))`` with the Transformer's fused-MLP dispatch, for
    encoders whose attention differs but whose MLP half is the standard
    pre-norm block."""
    if fused_mlp_eligible(x, mlp, mode):
        return apply_fused_mlp_block(norm, mlp, x)
    return x + mlp(norm(x))


class Transformer(nn.Module):
    """Pre-norm residual encoder stack (reference vit.py:87-104).

    ``layers[i]`` holds ``attn_norm``, ``attn``, ``mlp_norm`` and ``mlp``
    (``transformer/attn_norm_{i}`` … in the Flax tree).  ``compute_dtype`` is
    ``vit_tpu``'s ``dtype``, the dtype the stack computes in: the input is
    cast to it.  ``None`` means the parameter dtype at call time, so a stack
    cast with :func:`vit_tpu_torch.cast_params` computes in the cast dtype.
    See the module docstring for the device and the ``fused_attention`` /
    ``fused_mlp`` dispatch.
    """

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int,
                 mlp_dim: int, dropout: float = 0.0, fused_mlp: str = "auto",
                 fused_attention: str = "auto", *, device=None, dtype=None,
                 compute_dtype: torch.dtype | None = None, generator=None):
        super().__init__()
        self.fused_mlp = check_fused_mode("fused_mlp", fused_mlp)
        self.fused_attention = check_fused_mode("fused_attention", fused_attention)
        self.compute_dtype = compute_dtype
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.layers = nn.ModuleList(
            nn.ModuleDict({
                "attn_norm": LayerNorm(dim, **kw),
                "attn": Attention(dim, heads, dim_head, dropout, generator=generator, **kw),
                "mlp_norm": LayerNorm(dim, **kw),
                "mlp": MLP(dim, mlp_dim, dropout, generator=generator, **kw),
            })
            for _ in range(depth))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        param = next(self.parameters(), None)
        dtype = self.compute_dtype or (param.dtype if param is not None else x.dtype)
        x = x.to(dtype)
        for layer in self.layers:
            if fused_attention_eligible(x, layer["attn"], self.fused_attention):
                x = apply_fused_attention_block(layer["attn_norm"], layer["attn"], x)
            else:
                x = x + layer["attn"](layer["attn_norm"](x))
            x = fused_mlp_residual(x, layer["mlp_norm"], layer["mlp"], self.fused_mlp)
        return x
