"""Shared transformer and conv-hybrid primitives (port of the slice of
``vit_tpu/layers/common.py`` that ViT, CvT and ScalableViT need).

Numerics follow ``vit_tpu`` (and through it the TF reference): exact-erf GELU,
LayerNorm with eps 1e-3 and biased two-pass variance, glorot-uniform Dense
and Conv kernels with zero biases.  The conv hybrids work on NHWC maps:
``ChannelLayerNorm`` (eps 1e-5, biased variance), ``Conv`` and
``GroupedConv`` with TF-SAME padding, and a Flax-parity ``BatchNorm``.

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
``vit_tpu``.  ``"never"`` always runs the plain modules.

``Transformer(fused_attention="hybrid")`` opts into ``vit_tpu``'s
short-sequence tier (``vit_tpu/layers/common.py:304-314``, ``:507-548``):
where ``vit_tpu``'s gate holds — the activation one the kernels take, an
output projection, no active dropout, n < 128, b ≥ 64, b·n ≥ 2048, a head
geometry ``_attn_pack`` takes, and the fused MLP not opted out — the whole
stack runs on ``(n, b, d)`` activations, each layer ``ln_gemm →
attention_nb → proj_mlp`` (:func:`apply_fused_hybrid_layer`), with one
transpose before the stack and one after it.  Elsewhere ``"hybrid"`` does
what ``"auto"`` does.  It stays opt-in, as in ``vit_tpu``.  The TPU package's
``"interpret"`` and ``"bmajor"`` modes were TPU dispatch tiers and are
refused, as is ``"hybrid"`` anywhere but the ViT's ``fused_attention``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.ops._checks import KERNEL_DTYPES
from vit_tpu_torch.ops.attention import scaled_dot_product_attention
from vit_tpu_torch.ops.fused_attention_block import fused_attention_block
from vit_tpu_torch.ops.fused_hybrid import _attn_pack, attention_nb, ln_gemm, proj_mlp
from vit_tpu_torch.ops.fused_mlp import fused_mlp
from vit_tpu_torch.ops.patchify import conv2d_same

FUSED_MODES = ("auto", "never")
HYBRID_MODES = FUSED_MODES + ("hybrid",)  # the ViT Transformer's fused_attention
_TPU_ONLY_MODES = {
    "interpret": "ran the Pallas kernels in the TPU interpreter for CPU tests "
                 "(the port's CPU path is the kernels' plain PyTorch versions)",
    "hybrid": "opts into the batch-in-sublane (n, b, d) short-sequence tier "
              "(vit_tpu/ops/fused_hybrid.py), which the port takes only as the ViT "
              "Transformer's fused_attention",
    "bmajor": "forced the TPU's token-major block kernels outside their "
              "measured 128 <= n <= 1024 window",
}


def check_fused_mode(name: str, mode: str, modes: tuple = FUSED_MODES) -> str:
    """Validate a ``fused_attention`` / ``fused_mlp`` mode against ``modes``."""
    if mode in modes:
        return mode
    if mode in _TPU_ONLY_MODES:
        raise ValueError(
            f"{name}={mode!r} is a TPU-only mode here: it {_TPU_ONLY_MODES[mode]}. "
            f"This {name} takes {modes}.")
    raise ValueError(f"{name} must be one of {modes}, got {mode!r}")


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


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the channel axis of an NHWC map with biased variance
    and eps 1e-5, statistics in f32, output in the input dtype
    (``vit_tpu/layers/common.py:55-75``); parameters ``g`` and ``b`` of
    shape ``(dim,)``.  PyTorch's ``F.layer_norm`` over the f32 input
    computes exactly that in one kernel."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.b = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.g.shape, self.g.float(), self.b.float(),
                            self.eps).to(x.dtype)


class Conv(nn.Module):
    """Flax ``Conv`` over an NHWC map with TF-SAME padding: an OIHW
    ``weight`` (glorot-uniform) and a zero ``bias``, computed in the input
    dtype.  ``groups=in_channels`` makes it ``GroupedConv``.  A 1x1 stride-1
    conv is the GEMM ``F.linear`` over the channels (channels-last map)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True, groups: int = 1, *,
                 device=None, dtype=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), dtype=dtype)
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups,
                                               kernel_size, kernel_size, **kw))
        self.bias = nn.Parameter(torch.zeros(out_channels, **kw)) if use_bias else None
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = cast_to(self.weight, x), cast_to(self.bias, x)
        if w.shape[2:] == (1, 1) and self.stride == 1 and self.groups == 1:
            return F.linear(x, w.flatten(1), b)
        return conv2d_same(x, w, b, self.stride, self.groups)


class GroupedConv(Conv):
    """Depthwise ``Conv`` (one filter per channel), TF-SAME
    (``vit_tpu/layers/common.py:583-617``; its SPMD custom VJP is a TPU
    workaround the port does not need)."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1,
                 use_bias: bool = True, **kw):
        super().__init__(channels, channels, kernel_size, stride, use_bias, groups=channels, **kw)


class BatchNorm(nn.Module):
    """Flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the channel
    axis of an NHWC map.  ``momentum`` is PyTorch's, 1 - Flax's.

    Training mode normalises with the batch statistics, in f32: the mean and
    the biased variance; the running statistics take ``(1 - momentum)·running
    + momentum·batch`` with that *biased* variance, as Flax updates
    ``batch_stats`` (``nn.BatchNorm2d`` uses the unbiased one).  Eval mode
    normalises with the running statistics.  ``running_mean`` /
    ``running_var`` are f32 buffers, kept f32 by
    :func:`vit_tpu_torch.cast_params`; the output is in the input dtype.
    The normalisation is PyTorch's ``F.batch_norm`` over the f32 ``(rows,
    channels)`` view, one kernel each way; in training its batch statistics
    (and their gradient) are its own, and the running ones are updated
    beside it.  (Flax takes the variance as ``E[x²] - E[x]²``; the two
    agree to f32 rounding.)
    """

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5, *,
                 device=None, dtype=None):
        super().__init__()
        device = resolve_device(device)
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(dim, device=device))
        self.register_buffer("running_var", torch.ones(dim, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rows = x.float().reshape(-1, x.shape[-1])
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(rows, 0, correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        y = F.batch_norm(rows, None if self.training else self.running_mean,
                         None if self.training else self.running_var, self.weight.float(),
                         self.bias.float(), self.training, 0.0, self.eps)
        return y.reshape(x.shape).to(x.dtype)


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
    dropout, on an activation the kernels take (``"hybrid"`` outside its
    tier is ``"auto"``)."""
    return (mode in ("auto", "hybrid") and attn.project_out and not attn.dropout_active
            and kernel_activation(x))


def apply_fused_hybrid_layer(a_norm: LayerNorm, attn: Attention, m_norm: LayerNorm, mlp: MLP,
                             x: torch.Tensor) -> torch.Tensor:
    """One transformer layer on ``(n, b, d)`` activations
    (``vit_tpu/layers/common.py:190-255``): ``q, k, v = ln_gemm(x)`` →
    ``attention_nb`` → ``proj_mlp(x, o)``, from the parameters of the
    layer's two LayerNorms, its ``Attention`` and its ``MLP`` in the compute
    dtype (``x``'s); the LayerNorms' γ/β go as they are, and the ops round
    them."""
    q, k, v = ln_gemm(x, a_norm.weight, a_norm.bias, cast_to(attn.to_qkv.weight, x), a_norm.eps,
                      nsplit=3)
    o = attention_nb(q, k, v, attn.heads, attn.dim_head)
    out = attn.to_out[0]
    return proj_mlp(x, o, cast_to(out.weight, x), cast_to(out.bias, x), m_norm.weight,
                    m_norm.bias, cast_to(mlp.fc1.weight, x), cast_to(mlp.fc1.bias, x),
                    cast_to(mlp.fc2.weight, x), cast_to(mlp.fc2.bias, x), m_norm.eps)


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


def fused_conv_mlp_residual(x: torch.Tensor, norm: ChannelLayerNorm, mlp: nn.Module,
                            mode: str = "auto") -> torch.Tensor:
    """``x + mlp(norm(x))`` over an NHWC map, where ``mlp`` is a conv-MLP
    (``fc1`` and ``fc2`` 1x1 :class:`Conv` s, a ``dropout_active`` property):
    with :func:`fused_mlp_eligible`'s gate, through the fused MLP kernel on
    the ``(b, H·W, c)`` view, with the :class:`ChannelLayerNorm`'s eps
    (``vit_tpu/layers/common.py:400-452``); else the plain modules.
    ``vit_tpu``'s ``c >= 64`` and ``n >= 128`` gates were a TPU's lane and
    sublane reasons and do not carry over: every 16-bit CUDA call goes to the
    kernel, which raises on widths that are not multiples of 8."""
    if not fused_mlp_eligible(x, mlp, mode):
        return x + mlp(norm(x))
    b, h, w, c = x.shape
    y = fused_mlp(x.reshape(b, h * w, c).contiguous(), norm.g, norm.b, cast_to(mlp.fc1.weight, x).flatten(1),
                  cast_to(mlp.fc1.bias, x), cast_to(mlp.fc2.weight, x).flatten(1),
                  cast_to(mlp.fc2.bias, x), norm.eps)
    return y.reshape(b, h, w, c)


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
        self.fused_attention = check_fused_mode("fused_attention", fused_attention, HYBRID_MODES)
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

    def hybrid_tier(self, x: torch.Tensor) -> bool:
        """``vit_tpu``'s gate of the short-sequence tier for ``(b, n, d)``
        activations (``_fused_attention_tier``'s ``"nmajor"``, with the MLP
        gate it needs, ``vit_tpu/layers/common.py:312-319``, ``:514-519``)."""
        if self.fused_attention != "hybrid" or not self.layers:
            return False
        b, n = x.shape[0], x.shape[1]
        attn, mlp = self.layers[0]["attn"], self.layers[0]["mlp"]
        return (fused_attention_eligible(x, attn, "hybrid")
                and fused_mlp_eligible(x, mlp, self.fused_mlp)
                and n < 128 and b >= 64 and b * n >= 2048
                and _attn_pack(attn.heads, attn.dim_head) is not None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        param = next(self.parameters(), None)
        dtype = self.compute_dtype or (param.dtype if param is not None else x.dtype)
        x = x.to(dtype)
        if self.hybrid_tier(x):
            x = x.transpose(0, 1).contiguous()  # (n, b, d), once for the stack
            for layer in self.layers:
                x = apply_fused_hybrid_layer(layer["attn_norm"], layer["attn"],
                                             layer["mlp_norm"], layer["mlp"], x)
            return x.transpose(0, 1).contiguous()
        for layer in self.layers:
            if fused_attention_eligible(x, layer["attn"], self.fused_attention):
                x = apply_fused_attention_block(layer["attn_norm"], layer["attn"], x)
            else:
                x = x + layer["attn"](layer["attn_norm"](x))
            x = fused_mlp_residual(x, layer["mlp_norm"], layer["mlp"], self.fused_mlp)
        return x
