"""What a tensor-parallel block runs besides its split kernels: the sum over
the model ranks, the pass that ends a split block's forward, the LayerNorm
backward that ends its backward, and Megatron's two autograd functions for
the plain modules.

Tensor parallelism splits each transformer block over the ``model`` axis of
the mesh (:mod:`vit_tpu_torch.parallel.sharding`), Megatron's column→row
pairing: the QKV projection and fc1 by output columns (q, k and v each by
heads), the out-projection and fc2 by input rows.  Each rank computes a
partial sum of the block's output (and, backward, of the gradient at the
LayerNorm's output); one all-reduce (a sum) over the model group per block
each way completes it.  ``vit_tpu`` has no counterpart: there GSPMD gathers
a Pallas call's operands and keeps the unsharded numbers.

- :func:`bias_residual` ends a split forward, ``T(x + T(s + b))`` from the
  summed f32 partial s: the rounding points the unsplit kernels apply in
  their last GEMM's epilogue (``kEpiBiasResidual``), which a split block
  cannot use, since it would add the bias and the residual once per rank.
  CUDA: ``csrc/bias_residual.cu``; CPU: :func:`bias_residual_reference`.
- :func:`ln_backward` ends a split backward: the LayerNorm backward with its
  residual from the summed f32 dxn, ``dx`` and ``[dγ | dβ | Σ dy]``
  (``layernorm.cu``'s passes, ``vit_ln_bwd``).  The unsplit backwards fuse
  it into the dgrad's epilogue (``kEpiLnBwd``), which needs the whole dxn on
  chip; a rank holds only its partial.  CPU:
  :func:`ln_backward_residual_reference`.
- :func:`copy_to_model_parallel` (identity forward, all-reduce backward)
  before a column-split projection and :func:`reduce_from_model_parallel`
  (all-reduce forward, identity backward) after a row-split one: the plain
  modules' split, on the CPU, in f32 and under an active dropout.

Each wrapper on a CUDA tensor launches its kernel or raises; on a CPU tensor
it takes the plain version.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops._checks import KERNEL_DTYPES, launch_stream
from vit_tpu_torch.ops._shared import ln_backward_reference as _ln_backward


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``'s ranks, in place (every rank gets the
    same bits), and returned."""
    dist.all_reduce(t, group=group)
    return t


class _CopyToModelParallel(torch.autograd.Function):
    """The identity forward; the backward sums the gradient over the model
    group (Megatron's ``f``): the input of a column-split projection, which
    each rank reads whole and differentiates in part."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce_sum(dy.contiguous().clone(), ctx.group), None


class _ReduceFromModelParallel(torch.autograd.Function):
    """The sum over the model group forward, the identity backward
    (Megatron's ``g``): the partial output of a row-split projection."""

    @staticmethod
    def forward(ctx, s, group):
        return all_reduce_sum(s.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, ds):
        return ds, None


def copy_to_model_parallel(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModelParallel.apply(x, group)


def reduce_from_model_parallel(s: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModelParallel.apply(s, group)


def bias_residual_reference(s: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the pass: ``T(x + T(s + b))``, s (..., d)
    f32, b (d,) and x (..., d) in the compute dtype."""
    return x + (s + b.float()).to(x.dtype)


def _check_pass(name: str, x: torch.Tensor, tensors: dict) -> None:
    if x.dtype not in KERNEL_DTYPES or not x.is_contiguous() or x.shape[-1] % 8:
        raise ValueError(f"{name}: x must be a contiguous 16-bit CUDA tensor of a width "
                         f"divisible by 8, got {x.dtype} {tuple(x.shape)}")
    for label, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != x.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dtype} {tuple(shape)} "
                             f"tensor on {x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")


def bias_residual(s: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``T(x + T(s + b))``: a CPU tensor takes :func:`bias_residual_reference`,
    a CUDA tensor launches ``vit_bias_residual`` or raises.
    ``bias_residual.launches`` counts kernel launches."""
    if x.device.type == "cpu":
        return bias_residual_reference(s, b, x)
    d = x.shape[-1]
    _check_pass("bias_residual", x, {"s": (s, x.shape, torch.float32), "b": (b, (d,), x.dtype)})
    y = torch.empty_like(x)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.vit_bias_residual(s.data_ptr(), b.data_ptr(), x.data_ptr(), y.data_ptr(),
                                    x.numel() // d, d, _build.DTYPE_CODES[x.dtype],
                                    launch_stream(x))
    _build.check(err, "vit_bias_residual")
    bias_residual.launches += 1
    return y


bias_residual.launches = 0


def ln_backward_residual_reference(x, dxn32, gamma, dy, eps: float = 1e-3):
    """Plain PyTorch version of the LayerNorm backward with its residual:
    ``(dx, dgamma, dbeta, dsum)`` from x and dy (..., d) in the compute
    dtype, the f32 gradient dxn32 at the LayerNorm's output and gamma in the
    compute dtype: ``dx = T(dy + T(dx_ln))`` and the f32 column sums Σ
    dxn·xhat, Σ dxn and Σ dy (the block's output-bias gradient)."""
    d = x.shape[-1]
    dy2 = dy.reshape(-1, d)
    dx_ln, dgamma, dbeta = _ln_backward(x.reshape(-1, d).float(), dxn32.reshape(-1, d),
                                        gamma.float(), eps)
    dx = dy2 + dx_ln.to(dy.dtype)
    return dx.reshape(x.shape), dgamma, dbeta, dy2.float().sum(0)


def ln_backward(x, dxn32, gamma, dy, eps: float = 1e-3):
    """The LayerNorm backward with its residual, what
    :func:`ln_backward_residual_reference` returns: a CPU tensor takes it, a CUDA
    tensor launches ``vit_ln_bwd`` (``layernorm.cu``'s passes over the f32
    dxn) or raises.  ``ln_backward.launches`` counts kernel launches."""
    if dy.device.type == "cpu":
        return ln_backward_residual_reference(x, dxn32, gamma, dy, eps)
    d = x.shape[-1]
    rows = x.numel() // d
    _check_pass("ln_backward", dy, {"x": (x, dy.shape, dy.dtype), "gamma": (gamma, (d,), dy.dtype),
                                    "dxn": (dxn32, (rows, d), torch.float32)})
    f32 = dict(dtype=torch.float32, device=dy.device)
    lib = _build.load()
    dx = torch.empty_like(dy)
    sums = torch.empty(3 * d, **f32)
    stats = torch.empty((rows, 2), **f32)
    part = torch.empty((lib.vit_ln_bwd_partial_rows(rows), 3 * d), **f32)
    with torch.cuda.device(dy.device):
        err = lib.vit_ln_bwd(x.data_ptr(), dxn32.data_ptr(), gamma.data_ptr(), dy.data_ptr(),
                             dx.data_ptr(), stats.data_ptr(), part.data_ptr(), sums.data_ptr(),
                             rows, d, eps, _build.DTYPE_CODES[dy.dtype], launch_stream(dy))
    _build.check(err, "vit_ln_bwd")
    ln_backward.launches += 1
    dgamma, dbeta, dsum = sums.view(3, d).unbind(0)
    return dx, dgamma, dbeta, dsum


ln_backward.launches = 0
