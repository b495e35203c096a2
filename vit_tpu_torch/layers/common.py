"""Shared transformer and conv-hybrid primitives (port of
``vit_tpu/layers/common.py``, ``Transformer``'s scan and the SPMD-safe
``GroupedConv`` backward aside: TPU workarounds the port does not need).

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
``vit_tpu``: that attention takes ``scaled_dot_product_attention``'s tiers
(the flash kernels at 1024 tokens and more: T2T-ViT's first token
transformer).  ``"never"`` always runs the plain modules, the attention's
plain path included.

Random draws in training (dropout, stochastic depth) come from an explicit
``torch.Generator`` where a model passes one: :func:`dropout_mask` draws
every mask, in f32 on the generator's device, so a bf16 and an f32 model on
one seed draw the same masks (:func:`dropout`, :class:`DropPath`; the
``MLP``'s dropout when its forward is given a generator).  Without a
generator an active rate raises, as Flax does without a ``'dropout'`` rng;
only the ``MLP``'s own ``nn.Dropout`` draws from PyTorch's global RNG, for
the models that pass it no generator.

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

Tensor parallelism: :func:`vit_tpu_torch.parallel.sharding.shard_params`
splits each ``Transformer`` layer's ``Attention`` and ``MLP`` over the mesh's
``model`` axis and gives each a :class:`ModelShard` (``.shard``): the
attention keeps its rank's heads (``heads`` the local count; q, k and v each
cut by heads, the out-projection's columns), the MLP its rank's hidden units
(fc1's rows and bias, fc2's columns); the LayerNorms and the output biases
stay whole.  The kernel route runs the blocks' split forms (the autograd
Functions given the model group); the plain modules sum each row-split
projection's f32 partial over the group (:func:`~vit_tpu_torch.ops.
tensor_parallel.reduce_from_model_parallel`) and the gradient at each
column-split projection's input (:func:`~vit_tpu_torch.ops.tensor_parallel.
copy_to_model_parallel`), then add the bias once.  Dropout under the model
axis draws from the forward's generator, which every rank of a model group
holds on one seed: the full-width masks, each rank taking its hidden units'
slice of the MLP's, so that a split step equals the one-process step with
that generator; an active dropout without a generator raises there.  The
conv hybrids' split modules (Twins-SVT, CvT, LeViT, MobileViT) do the same
with :func:`split_input` (``f``, right before each column-split projection,
after any replicated prefix), :func:`row_parallel_conv` /
:func:`row_parallel_output` (``g`` and the bias once) and
:func:`split_dropout`, each the plain op on a module that is not split, and
declare what ``shard_params`` cuts as ``tp_cuts`` (``{name: COLUMN | ROW |
QKV | KV}``).  An ``Attention`` or ``MLP`` outside a ``Transformer`` (Parallel
ViT's branches, DeepViT's, the patch merger's, CaiT's and CrossViT's layers)
is split as a ``Transformer``'s is; CaiT's talking heads and DeepViT's
re-attention mix all heads with one ``(heads, heads)`` matrix, which
:func:`~vit_tpu_torch.ops.tensor_parallel.mix_across_heads` splits by heads.
An attention outside a ``Transformer`` whose heads the axis does not divide
runs whole on every rank with the shard :data:`WHOLE`: no collective (every
helper here takes :data:`WHOLE` for a module that is not split), and its
dropout draws from the generator as the split modules' does.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from vit_tpu_torch.core.helpers import resolve_device
from vit_tpu_torch.ops._checks import KERNEL_DTYPES
from vit_tpu_torch.ops.attention import scaled_dot_product_attention
from vit_tpu_torch.ops.fused_attention_block import fused_attention_block
from vit_tpu_torch.ops.fused_hybrid import _attn_pack, attention_nb, ln_gemm, proj_mlp
from vit_tpu_torch.ops.fused_mlp import fused_mlp
from vit_tpu_torch.ops.patchify import conv2d_same, same_pads
from vit_tpu_torch.ops.tensor_parallel import copy_to_model_parallel, reduce_from_model_parallel

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


def dropout_mask(generator: torch.Generator, shape, keep: float) -> torch.Tensor:
    """A boolean mask of ``shape``, each element True with probability
    ``keep``: uniform f32 draws from ``generator`` on its device below
    ``keep``, as ``jax.random.bernoulli`` draws.  Every dropout and
    stochastic-depth mask of the port's models is drawn here, so that a bf16
    and an f32 model on one seed get the same masks and tests can inject one
    draw into both packages."""
    return torch.rand(shape, generator=generator, device=generator.device) < keep


def _drop(x: torch.Tensor, shape, keep: float, generator: torch.Generator | None,
          what: str) -> torch.Tensor:
    """``x / keep`` where a :func:`dropout_mask` of ``shape`` (broadcast over
    ``x``) keeps it, 0 elsewhere, in ``x``'s dtype; raises without a
    generator."""
    if generator is None:
        raise ValueError(f"{what} in training draws from an explicit generator: pass "
                         f"generator= to the forward")
    mask = dropout_mask(generator, shape, keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax's ``nn.Dropout(rate)(x, deterministic=not training)``: in
    training at a rate above 0, each element kept with probability ``1 -
    rate`` (:func:`dropout_mask`) and scaled by its inverse, in ``x``'s
    dtype; the identity otherwise.  Raises without a generator where it
    draws."""
    if rate == 0.0 or not training:
        return x
    if rate == 1.0:  # Flax's edge case
        return torch.zeros_like(x)
    return _drop(x, x.shape, 1.0 - rate, generator, "dropout")


def dropout_shard(x: torch.Tensor, rate: float, training: bool,
                  generator: torch.Generator | None, shard: "ModelShard") -> torch.Tensor:
    """:func:`dropout` of this rank's slice of a column-split activation
    (``x``'s last axis: ``shard.rank``'s part of ``shard.size``): the
    full-width mask drawn from ``generator``, as one process draws it, and
    this rank's columns of it."""
    if rate == 0.0 or not training:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if generator is None:
        raise ValueError("dropout in training draws from an explicit generator: pass "
                         "generator= to the forward")
    width, keep = x.shape[-1], 1.0 - rate
    full = dropout_mask(generator, x.shape[:-1] + (width * shard.size,), keep)
    mask = full[..., shard.rank * width:(shard.rank + 1) * width].to(x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@dataclass(frozen=True)
class ModelShard:
    """Where a split module sits on the mesh's ``model`` axis: the axis'
    process group, this rank's place on it and its size."""

    group: object
    rank: int
    size: int


# How shard_params cuts a parameter or buffer (and a checkpoint gathers it):
# by rows (dim 0), by columns (dim 1), or by rows in each third of a packed
# q|k|v or each half of a packed k|v.
COLUMN, ROW, QKV, KV = "column", "row", "qkv", "kv"

# What shard_params cuts of an MLP (layers/common.py's, or any fc1 / fc2
# pair): fc1's rows and bias, fc2's columns.
MLP_CUTS = {"fc1.weight": COLUMN, "fc1.bias": COLUMN, "fc2.weight": ROW}

WHOLE = ModelShard(None, 0, 1)
"""The shard of an attention outside a ``Transformer`` that runs whole inside
a split model (its heads do not divide over the axis): no collective, and
its dropout draws from the forward's generator, so that the ranks draw one
mask."""


def _splits(shard: ModelShard | None) -> bool:
    return shard is not None and shard.size > 1


def is_split(module: nn.Module) -> bool:
    """Whether ``module`` is split over a model axis of more than one rank."""
    return _splits(getattr(module, "shard", None))


def model_shard(model: nn.Module) -> ModelShard | None:
    """The :class:`ModelShard` of a model ``shard_params`` has split, or None:
    what a model-level dropout (``emb_dropout``) passes :func:`split_dropout`,
    so that it draws from the forward's generator once the model is split."""
    plan = getattr(model, "tensor_parallel", None)
    return None if plan is None else plan.shard


def row_parallel_output(proj: nn.Linear, x: torch.Tensor,
                        shard: ModelShard | None) -> torch.Tensor:
    """A row-split projection's output in ``x``'s dtype: this rank's f32
    partial ``x·Wᵀ`` summed over the model group, then the (whole) bias
    added once, ``T(Σ + b)``; :func:`linear` where ``shard`` splits
    nothing."""
    if not _splits(shard):
        return linear(proj, x)
    return _row_parallel(cast_to(proj.weight, x), cast_to(proj.bias, x), x, shard)


def row_parallel_conv(conv: "Conv", x: torch.Tensor, shard: ModelShard | None) -> torch.Tensor:
    """:func:`row_parallel_output` of a row-split 1x1, stride-1 :class:`Conv`
    over a channels-last map (the GEMM over its channels): the bias, if
    any, added once after the sum; ``conv(x)`` where ``shard`` splits
    nothing."""
    if not _splits(shard):
        return conv(x)
    if conv.weight.shape[2:] != (1, 1) or conv.stride != 1 or conv.groups != 1:
        raise ValueError("row_parallel_conv: a row split takes a 1x1, stride-1 convolution")
    return _row_parallel(cast_to(conv.weight, x).flatten(1), cast_to(conv.bias, x), x, shard)


def _row_parallel(w: torch.Tensor, b: torch.Tensor | None, x: torch.Tensor,
                  shard: ModelShard) -> torch.Tensor:
    s = reduce_from_model_parallel(F.linear(x.float(), w.float()), shard.group)
    return (s if b is None else s + b.float()).to(x.dtype)


def split_input(x: torch.Tensor, shard: ModelShard | None) -> torch.Tensor:
    """Megatron's ``f`` before a split module's column-split projections
    (:func:`~vit_tpu_torch.ops.tensor_parallel.copy_to_model_parallel`), the
    identity where ``shard`` splits nothing."""
    return copy_to_model_parallel(x, shard.group) if _splits(shard) else x


def split_dropout(x: torch.Tensor, drop: nn.Dropout, shard: ModelShard | None,
                  generator: torch.Generator | None = None, *,
                  hidden: bool = False) -> torch.Tensor:
    """``drop``'s dropout of ``x`` in a conv hybrid's module: ``drop(x)``
    (PyTorch's global RNG) where the model is not split and no generator is
    given; else :func:`dropout` of its rate drawn from ``generator`` (on a
    split module's column-split activation, ``hidden``, this rank's slice of
    the full-width mask, :func:`dropout_shard`), so that a split model's
    ranks draw one mask and equal the one-process forward given the same
    generator.  Raises there without a generator where the dropout is
    active."""
    if shard is None and generator is None:
        return drop(x)
    if hidden and _splits(shard):
        return dropout_shard(x, drop.p, drop.training, generator, shard)
    return dropout(x, drop.p, drop.training, generator)


class DropPath(nn.Module):
    """Per-sample stochastic depth (``vit_tpu/layers/common.py:565-580``):
    in training at a rate above 0, each sample's branch kept with probability
    ``1 - rate`` (a ``(b, 1, …)`` :func:`dropout_mask`) and scaled by its
    inverse, in ``x``'s dtype; the identity in eval mode or at rate 0.  The
    draw comes from the forward's ``generator``, without which it raises."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        return _drop(x, shape, 1.0 - self.rate, generator, "stochastic depth")


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """Flax's ``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")`` on an
    NHWC map: TF-SAME pads (:func:`~vit_tpu_torch.ops.patchify.same_pads`, the
    odd one after: (0, 1) from 56 to 28) of −inf, then a pool without
    padding.  ``F.max_pool2d(padding=1)`` would pad (1, 1): the same size,
    shifted windows."""
    (top, bottom), (left, right) = (same_pads(x.shape[1 + i], kernel, stride) for i in range(2))
    x = F.pad(x, (0, 0, left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride).permute(0, 2, 3, 1)


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


def output_projection(inner: int, dim: int, dropout: float, generator=None, *, device=None,
                      dtype=None) -> nn.Sequential:
    """An attention's ``to_out``: the Dense back to ``dim`` and its dropout
    (``to_out.0`` / ``to_out.1``; the converter maps Flax's ``to_out`` to
    ``to_out.0``)."""
    return nn.Sequential(_linear(inner, dim, True, device, dtype, generator), nn.Dropout(dropout))


def cast_to(p: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """A parameter in ``x``'s dtype, cast inside autograd (a no-op when it
    already is), so that its gradient reaches the parameter's own dtype."""
    return None if p is None else p.to(x.dtype)


def linear(module: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` computed in ``x``'s dtype (the compute dtype)."""
    return F.linear(x, cast_to(module.weight, x), cast_to(module.bias, x))


def apply_output(to_out: nn.Sequential, x: torch.Tensor, shard: ModelShard | None = None,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """An :func:`output_projection` applied in ``x``'s dtype: a row-split
    one's partial summed over ``shard``'s group (:func:`row_parallel_output`),
    its dropout as :func:`split_dropout` draws it."""
    return split_dropout(row_parallel_output(to_out[0], x, shard), to_out[1], shard, generator)


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
    """Depthwise ``Conv`` (one group per input channel), TF-SAME
    (``vit_tpu/layers/common.py:583-617``; its SPMD custom VJP is a TPU
    workaround the port does not need).  ``out_channels`` (``channels`` by
    default) is Flax's ``features``: a multiple m of ``channels`` gives each
    input channel m outputs, output o from input o // m in both packages
    (PiT's pools, m = 2), and Flax's ``(kh, kw, 1, out)`` kernel is the OIHW
    ``(out, 1, kh, kw)`` weight."""

    def __init__(self, channels: int, kernel_size: int, stride: int = 1,
                 use_bias: bool = True, out_channels: int | None = None, **kw):
        super().__init__(channels, out_channels or channels, kernel_size, stride, use_bias,
                         groups=channels, **kw)


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

    Inside :func:`synced_batch_norm` with a process group (a data-parallel
    train step over more than one rank), training takes the statistics of
    the global batch, as ``vit_tpu``'s BatchNorm under a mesh: one
    differentiable all-reduce of the f32 per-channel sums of x and x² and
    the row count, then the mean and the biased variance ``E[x²] - E[x]²``,
    with which it normalises and updates the running statistics, so every
    rank holds the same buffers.  Without a group the forward is the one
    above.
    """

    sync_group = None  # set by synced_batch_norm for the step's forward

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
        if self.training and self.sync_group is not None:
            return self._synced(rows).reshape(x.shape).to(x.dtype)
        if self.training:
            with torch.no_grad():
                var, mean = torch.var_mean(rows, 0, correction=0)
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
        y = F.batch_norm(rows, None if self.training else self.running_mean,
                         None if self.training else self.running_var, self.weight.float(),
                         self.bias.float(), self.training, 0.0, self.eps)
        return y.reshape(x.shape).to(x.dtype)

    def _synced(self, rows: torch.Tensor) -> torch.Tensor:
        """Training over the global batch of ``sync_group``'s ranks."""
        from torch.distributed.nn.functional import all_reduce

        c = rows.shape[1]
        count = torch.full((1,), float(rows.shape[0]), device=rows.device)
        sums = all_reduce(torch.cat([rows.sum(0), rows.square().sum(0), count]),
                          group=self.sync_group)
        mean = sums[:c] / sums[-1]
        var = sums[c:2 * c] / sums[-1] - mean.square()
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        return (rows - mean) * torch.rsqrt(var + self.eps) * self.weight.float() \
            + self.bias.float()


@contextlib.contextmanager
def synced_batch_norm(model: nn.Module, group):
    """Every :class:`BatchNorm` of ``model`` takes its training statistics
    over ``group``'s ranks for the block (nothing changes with ``group``
    None)."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)] if group is not None else []
    for m in norms:
        m.sync_group = group
    try:
        yield
    finally:
        for m in norms:
            m.sync_group = None


class MLP(nn.Module):
    """Dense→GELU→Dropout→Dense→Dropout (reference vit.py:24-47).  ``shard``
    (a :class:`ModelShard`, set by ``shard_params``) splits it over the
    model axis: see the module docstring."""

    shard = None

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

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the dropout's draws (:func:`dropout`); without it an
        active dropout draws from ``nn.Dropout``'s global RNG (and raises
        when split)."""
        x = gelu_exact(linear(self.fc1, split_input(x, self.shard)))
        x = split_dropout(x, self.dropout, self.shard, generator, hidden=True)
        return split_dropout(row_parallel_output(self.fc2, x, self.shard), self.dropout,
                             self.shard, generator)


class Attention(nn.Module):
    """Multi-head self-attention (reference vit.py:49-85): fused qkv
    projection without bias, output projection + dropout unless single-head
    with ``dim_head == dim``.  ``shard`` (a :class:`ModelShard`, set by
    ``shard_params``) splits it over the model axis by heads: see the module
    docstring."""

    shard = None

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
            self.to_out = output_projection(inner, dim, dropout, generator, device=device,
                                            dtype=dtype)
        else:
            self.to_out = nn.Identity()

    @property
    def dropout_active(self) -> bool:
        return self.project_out and self.training and self.to_out[1].p > 0

    def forward(self, x: torch.Tensor, use_flash: str = "auto",
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``use_flash`` as :func:`scaled_dot_product_attention` takes it;
        ``generator``: the output dropout's draws (:func:`dropout`), without
        which an active dropout draws from ``nn.Dropout``'s global RNG (and
        raises when split)."""
        b, n, _ = x.shape
        x = split_input(x, self.shard)
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in linear(self.to_qkv, x).chunk(3, dim=-1))
        out = scaled_dot_product_attention(q, k, v, scale=self.dim_head ** -0.5,
                                           use_flash=use_flash)
        out = out.transpose(1, 2).reshape(b, n, self.heads * self.dim_head)
        if not self.project_out:
            return out
        return apply_output(self.to_out, out, self.shard, generator)


def kernel_activation(x: torch.Tensor) -> bool:
    """Whether ``x`` is an activation the CUDA block kernels take: a 16-bit
    CUDA tensor.  The kernel wrappers then check the widths, and raise rather
    than run the plain path."""
    return x.is_cuda and x.dtype in KERNEL_DTYPES


def apply_fused_mlp_block(norm: LayerNorm, mlp: MLP, x: torch.Tensor) -> torch.Tensor:
    """``x + mlp(norm(x))`` through the fused MLP kernel, from the parameters
    of the ``LayerNorm`` / ``MLP`` pair in the compute dtype (``x``'s); the
    LayerNorm's γ/β go as they are, and the op rounds them; a split MLP
    runs the op's split form over its model group."""
    return fused_mlp(x, norm.weight, norm.bias, cast_to(mlp.fc1.weight, x),
                     cast_to(mlp.fc1.bias, x), cast_to(mlp.fc2.weight, x),
                     cast_to(mlp.fc2.bias, x), norm.eps, group=_group(mlp))


def _group(module) -> object:
    """A split module's model group, or None."""
    return module.shard.group if is_split(module) else None


def group_kw(module) -> dict:
    """``{"group": ...}`` for a split module's op call, ``{}`` for a whole
    one (whose call stays the unsplit op's)."""
    group = _group(module)
    return {} if group is None else {"group": group}


def apply_fused_attention_block(norm: LayerNorm, attn: Attention,
                                x: torch.Tensor) -> torch.Tensor:
    """``x + attn(norm(x))`` through the fused attention-block kernel, from
    the parameters of the ``LayerNorm`` / ``Attention`` pair, as
    :func:`apply_fused_mlp_block`."""
    out = attn.to_out[0]
    return fused_attention_block(x, norm.weight, norm.bias, cast_to(attn.to_qkv.weight, x),
                                 cast_to(out.weight, x), cast_to(out.bias, x), attn.heads,
                                 attn.dim_head, attn.dim_head ** -0.5, norm.eps,
                                 group=_group(attn))


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
    return fused_mlp_gate(x, mlp.dropout_active, mode)


def fused_mlp_gate(x: torch.Tensor, dropout_active: bool, mode: str) -> bool:
    """:func:`fused_mlp_eligible` from the dropout state itself, for an MLP
    that is not one module (NesT's loose ``fc1`` / ``fc2`` pair)."""
    return mode == "auto" and not dropout_active and kernel_activation(x)


def windowed_attention_eligible(x: torch.Tensor, attn: nn.Module, mode: str = "auto") -> bool:
    """The gate of the windowed fused-attention path
    (``vit_tpu/layers/common.py:369-397``), for a model that folds windows
    of ``x`` into the batch and runs the fused attention block over them
    (Twins-SVT's local attention, CrossFormer's short and long ones): no
    active dropout (``attn`` has a ``dropout_active`` property), on an
    activation the kernels take.
    ``vit_tpu``'s ``d >= 64``, ``n <= 512`` and ``groups·n >= 2048`` gates
    were a v5e's lane, VMEM and grid reasons and do not carry over: the
    port's block takes any n (past 512 tokens on its mha route,
    :func:`~vit_tpu_torch.ops.fused_attention_block.attention_route`), and
    widths it does not take raise."""
    return mode == "auto" and not attn.dropout_active and kernel_activation(x)


def fused_mlp_residual(x: torch.Tensor, norm: LayerNorm, mlp: MLP, mode: str = "auto",
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """``x + mlp(norm(x))`` with the Transformer's fused-MLP dispatch, for
    encoders whose attention differs but whose MLP half is the standard
    pre-norm block; ``generator`` goes to the plain ``MLP``'s dropout."""
    if fused_mlp_eligible(x, mlp, mode):
        return apply_fused_mlp_block(norm, mlp, x)
    return x + mlp(norm(x), generator=generator)


def fused_conv_mlp_residual(x: torch.Tensor, norm: ChannelLayerNorm | None,
                            mlp: nn.Module | None, mode: str = "auto", *,
                            fc1: Conv | None = None, fc2: Conv | None = None,
                            dropout: nn.Dropout | None = None,
                            generator: torch.Generator | None = None,
                            shard: ModelShard | None = None) -> torch.Tensor:
    """``x + mlp(norm(x))`` over an NHWC map, where ``mlp`` is a conv-MLP
    (``fc1`` and ``fc2`` 1x1 :class:`Conv` s, a ``dropout_active`` property):
    with :func:`fused_mlp_eligible`'s gate, through the fused MLP kernel on
    the ``(b, H·W, c)`` view, with the :class:`ChannelLayerNorm`'s eps
    (``vit_tpu/layers/common.py:400-452``); else the plain modules.  A
    split ``mlp`` (its ``shard`` set) runs the kernel's split form over its
    model group.
    ``norm=None`` is ``vit_tpu``'s form for an MLP that holds its LayerNorm
    as ``mlp.norm`` (CrossFormer's, ``:413-415``, ``:437-441``): ``x +
    mlp(x)``, the kernel taking that norm's g, b and eps.
    ``mlp=None`` with ``fc1``, ``fc2`` and ``dropout`` is its form for convs
    that no module holds (NesT's, ``vit_tpu/models/nest.py:122-141``): the
    plain path ``x + dropout(fc2(dropout(gelu(fc1(norm(x))))))``, the gate
    on ``dropout``'s state; ``shard`` (its owner's, set by
    ``shard_params``) splits that pair as a split ``mlp`` is split, the
    plain path with :func:`split_input`, :func:`row_parallel_conv` and
    :func:`split_dropout`.  ``generator``, where given, goes to the plain
    ``mlp``'s forward (its dropout's draws) or the loose pair's dropout.
    ``vit_tpu``'s ``c >= 64`` and ``n >= 128`` gates were a TPU's lane and
    sublane reasons and do not carry over: every 16-bit CUDA call goes to the
    kernel."""
    if mlp is not None:
        fc1, fc2, active = mlp.fc1, mlp.fc2, mlp.dropout_active
        shard = getattr(mlp, "shard", None)
    else:
        active = dropout.training and dropout.p > 0
    if not fused_mlp_gate(x, active, mode):
        xn = x if norm is None else norm(x)
        if mlp is not None:
            return x + (mlp(xn) if generator is None else mlp(xn, generator=generator))
        hdn = gelu_exact(fc1(split_input(xn, shard)))
        hdn = split_dropout(hdn, dropout, shard, generator, hidden=True)
        return x + split_dropout(row_parallel_conv(fc2, hdn, shard), dropout, shard, generator)
    ln = mlp.norm if norm is None else norm
    b, h, w, c = x.shape
    y = fused_mlp(x.reshape(b, h * w, c).contiguous(), ln.g, ln.b,
                  cast_to(fc1.weight, x).flatten(1), cast_to(fc1.bias, x),
                  cast_to(fc2.weight, x).flatten(1), cast_to(fc2.bias, x), ln.eps,
                  **({"group": shard.group} if _splits(shard) else {}))
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

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the draws of an active dropout on the plain
        modules (:func:`dropout`)."""
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
                x = x + layer["attn"](layer["attn_norm"](x), use_flash="never"
                                      if self.fused_attention == "never" else "auto",
                                      generator=generator)
            x = fused_mlp_residual(x, layer["mlp_norm"], layer["mlp"], self.fused_mlp, generator)
        return x


class PEG(nn.Module):
    """Positional Encoding Generator (``vit_tpu/layers/common.py:620-638``):
    ``x + proj(x)`` over an NHWC map, ``proj`` a depthwise TF-SAME
    :class:`GroupedConv` with bias."""

    def __init__(self, dim: int, kernel_size: int = 3, **kw):
        super().__init__()
        self.proj = GroupedConv(dim, kernel_size, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x) + x


class DepthWiseConv2d(nn.Module):
    """Depthwise conv → optional BatchNorm → pointwise 1x1 conv
    (``vit_tpu/layers/common.py:641-679``): ``depthwise`` a TF-SAME
    :class:`GroupedConv` of ``stride``, ``bn`` (with ``use_bn``) Keras'
    BatchNorm (:func:`batchnorm`), ``pointwise`` a :class:`Conv`.  Flax
    infers ``dim_in``; the port takes it, as its conv layers do."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int, stride: int = 1,
                 use_bias: bool = True, use_bn: bool = False, **kw):
        super().__init__()
        gen = kw.pop("generator", None)
        self.depthwise = GroupedConv(dim_in, kernel_size, stride, use_bias, generator=gen, **kw)
        self.bn = batchnorm(dim_in, **kw) if use_bn else None
        self.pointwise = Conv(dim_in, dim_out, 1, use_bias=use_bias, generator=gen, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.depthwise(x)
        return self.pointwise(x if self.bn is None else self.bn(x))


class Downsample(nn.Module):
    """A 3x3, stride-2 TF-SAME :class:`Conv` with bias, ``conv``
    (``vit_tpu/layers/common.py:682-698``)."""

    def __init__(self, dim_in: int, dim_out: int, **kw):
        super().__init__()
        self.conv = Conv(dim_in, dim_out, 3, 2, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


def batchnorm(dim: int, **kw) -> BatchNorm:
    """Keras' BatchNorm (``tf.keras.layers.BatchNormalization``'s momentum
    0.99 and epsilon 1e-3; ``vit_tpu/layers/common.py:701-712``) as the
    port's :class:`BatchNorm`: PyTorch's momentum 1 - 0.99.  Training mode is
    the module's own."""
    return BatchNorm(dim, momentum=0.01, eps=1e-3, **kw)


class PreNorm(nn.Module):
    """``fn(norm(x), **kwargs)``, ``norm`` the token :class:`LayerNorm`
    (eps 1e-3; ``vit_tpu/layers/common.py:715-725``), for users composing
    their own encoders."""

    def __init__(self, dim: int, fn: nn.Module, *, device=None, dtype=None):
        super().__init__()
        self.norm = LayerNorm(dim, device=device, dtype=dtype)
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.fn(self.norm(x), **kwargs)


class Residual(nn.Module):
    """``fn(x, **kwargs) + x`` (``vit_tpu/layers/common.py:728-735``)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.fn(x, **kwargs) + x
