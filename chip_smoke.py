#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card,
and check them.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, one line each (any failure raises and exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions; TF32 off
   for the plain versions and the f32 references.
2. build: compiles ``vit_tpu_torch/csrc`` with nvcc, one process per source
   (timed); then ptxas's registers, static shared memory and spills of each
   instance of the kernels built on wgmma and TMA (the flash forward, the
   flash backward's dq and dk/dv kernels, the short-attention forward and
   backward kernels, the wgmma GEMM of the blocks' and the hybrid layer's
   GEMMs).
3. forward GEMMs: the blocks' forward GEMMs (fc1 keeping h, fc2, QKV, the
   out-projection) at ViT-B/32's, ViT-B/16's and ScalableViT's four stage
   widths, on gemm_wgmma.cu's kernel and on linear.cu's, each against the
   plain GEMM, timed in turns: the measurement behind launch_forward_gemm's
   threshold.  Then kernels: each forward kernel against its plain PyTorch
   version (the attention block on the short route also against that
   route's own plain version) and twice bit for bit, at the ViT-B/16 @224
   shapes (b=64, n=197, d=768, 12 heads of 64, h=3072), bench.py's B/32
   (b=128, n=65, d=1024, 16 heads of 64, h=2048) and the entry shapes (b=8),
   bf16 inputs from a seeded generator; times of the kernel, its plain
   version and the plain modules (bf16 through PyTorch's own GEMMs) with CUDA
   events around runs of back-to-back calls.
4. training kernels, at the B/16 training shapes (b=64) and the B/32 ones
   (b=128, n=65), from seeded bf16 inputs and cotangent: each training
   forward (the kernels that keep xn, h and xn, qkv, oattn, lse) against its
   plain version, output by output, twice bit for bit; then each backward
   kernel, fed those kept
   residuals, against its plain backward on them, output by output; times of
   the backward kernel, its plain version and PyTorch autograd through the
   plain bf16 modules for the same outputs, and of the kernel plus its dW
   GEMMs against autograd with the weight gradients.
5. serving: ViT-B/16 @224, random weights from a seed, bf16 via
   ``cast_params``, eval, ``inference_mode``; three requests of 64 NHWC
   images.  Each forward must launch each kernel ``depth`` times; logits must
   be finite, (64, 1000), and agree with the same weights under
   ``fused_attention="never", fused_mlp="never"`` in bf16 (the plain path)
   and in f32 (the reference): the kernel path must be as close to the f32
   reference as the plain bf16 path is (within 2x its largest logit error,
   and agreeing with its top-1 at least as often), and agree with the plain
   path on 99% of the top-1s that the plain path's bf16 noise cannot flip.
   Median forward times of both paths.
6. entry: the same at ViT-B/32 @256 (dim 1024, depth 6), batch 8.
7. training: ``make_train_step`` over ``ViT(..., compute_dtype=bf16)`` with
   f32 parameters and ``torch.optim.SGD(lr=1e-3)``, at bench.py's config
   (ViT-B/32 @256, dim 1024, depth 6, heads 16, mlp 2048, batch 128, labels
   ``arange(128) % 1000``) and at ViT-B/16 @224, batch 64.  The step-1
   gradients of the kernel path and of the plain bf16 path are held against
   an f32 model of the same weights; then four steps on one batch, each
   launching each of the four kernels ``depth`` times, with finite, falling
   losses; median step times of both paths.
8. biased kernels, at the small-dataset ViT's block (b=64, n=257, d=1024, 16
   heads of 64), bf16 inputs from a seeded generator, with (i) LSA's
   diagonal -f32.max bias and scale 1.0, (ii) a random (1, n, n) bias, (iii)
   a random (16, n, n) bias, on the short route: the serving and the
   training forward and the backward against their plain versions (the TPU
   kernel's rounding points and the route's own), output by output, dbias for
   (ii) and (iii) against the route's own under its bound
   (:func:`check_dbias`; its distance from the TPU kernel's rounding points
   printed beside, not held) and twice, bit for bit; times of the kernel, the
   unbiased kernel on the same inputs, the plain version and the bf16
   modules with ``scaled_dot_product_attention`` (``attn_mask=bias``;
   autograd through them for the backward).
9. SPT: the small-dataset tokenizer's convolution form against its eager
   form, both bf16, and the f32 eager form, at 256 px, patch 16, dim 1024,
   batch 64; times of both.
10. small-dataset serving and training: phases 5 and 7 for
   ``vit_for_small_dataset.ViT`` at ``benchmarks/run_benchmarks.py``'s
   config (256/16, dim 1024, depth 6, heads 16, mlp 2048), batch 64: each
   forward launches the biased block and the MLP kernels ``depth`` times
   (each step their backwards too) and the unbiased block never.  Top-1
   against f32 is held to the plain path's up to chance (a sign test): the
   plain LSA keeps an exact f32 softmax that the kernel route does not.
   Each temperature's step-1 gradient is held to one bf16 unit of the
   terms it sums (:func:`check_temperatures`), at the phase's seed and a
   second one.
11. flash kernels, bf16 inputs from a seeded generator laid out as CvT hands
   them over (q a view of a channels-last (b, n, h·d) map, k and v views of
   the two halves of one (b, n, 2·h·d) projection), at CvT-13's shapes
   (64, 1, 3136 | 784, 64), (64, 1, 9216 | 2304, 64) and (64, 3, 2304 | 576,
   64), at (4, 16, 8192, 64) through ``scaled_dot_product_attention`` (vit_tpu's
   flash_attention_v2 tier) and at (64, 2, 4096, 32): out and lse against the
   plain version, dq/dk/dv against the plain backward fed the kernel's own out
   and lse, the backward twice bit for bit; times of the kernel, its plain
   version and PyTorch's ``scaled_dot_product_attention`` (autograd through it
   for the backward), and the bound.  Then, below the 1024 gate, at CvT's
   stage-2 and stage-3 shapes: the kernel against the dispatcher's plain path
   and SDPA, forward and backward.
12. CvT-13 (``vit_tpu``'s CvT defaults, ``benchmarks/run_benchmarks.py:91``)
   serving at 224 and 384 px, batch 64, as phase 5 (its plain path is
   ``use_flash="never"``): the flash kernel launches once per forward at 224
   (stage 1) and three times at 384 (stages 1 and 2); and training at 224 and
   384, batch 64, as phase 7, the flash forward and backward launched 1 and 3
   times per step, BatchNorm's running statistics finite and updated.
13. cross-attention block (``fused_cross_attention``), at ScalableViT's four
   SSA shapes, batch 64 (4096 | 1024 | 256 | 64 queries of 64 | 128 | 256 |
   512 channels, 2 | 4 | 8 | 16 heads, 64 keys, q/k 40 wide and v 32 at
   stages 1-3, both 32 at stage 4: one ``cross_fwd`` launch, from 256
   channels with the y GEMM) and at ScalableViT@384's stage 1 (144 keys, batch
   16: the three-launch forward), seeded bf16 inputs: the serving and the
   training forward (y, q, oattn, lse) against the plain version, the
   backward (dxn, dq, dk, dv, dbo), fed the training forward's residuals, on
   the route its shape takes (one ``cross_bwd`` kernel and its reduction up
   to 128 channels, ``cross_bwd`` between two ``gemm_wgmma`` dgrads from 129,
   the four steps past 128 keys), against the plain backward and twice bit
   for bit, and at the ``cross_bwd`` shapes the other designs (the four
   steps; the split at stages 1-2) against theirs; times of the kernels, the
   other designs, the plain versions and F.linear + SDPA + F.linear
   (autograd through it), with and without the dW GEMMs, and the bounds; at
   the four SSA shapes the backward's device time launch by launch on its
   route and on the four steps.
14. packed flash (``flash_attention_packed``), channel-packed (b, n, heads·d)
   inputs at ScalableViT's IWSA windows (64, 4096, 2x32) and (64, 1024,
   4x32) and at dk 40, dv 32: out and lse against the plain version, the
   backward on the packed strides against the plain backward, twice bit for
   bit; times against SDPA on the head views, and the bounds.
15. ScalableViT (``benchmarks/run_benchmarks.py:140-144``: dim 64, heads 2 /
   4 / 8 / 16, depths 2 / 2 / 8 / 2, SSA keys 40 / 40 / 40 / 32, reductions
   8 / 4 / 2 / 1, windows 64 / 32 / whole / whole) at 256 px, batch 64:
   serving as phase 5 and training as phase 7, its plain path
   ``fused_attention="never", fused_mlp="never"``; each forward launches the
   cross-attention block 14 times, the packed flash op 4 times (the IWSA
   windows of 1024 tokens and more) and the fused MLP 28 times, each step
   their backwards as often (the cross-attention backward 4 times as one
   ``cross_bwd`` kernel, at stages 1-2, and 10 times split, at 3-4).
16. hybrid kernels (the short-sequence tier's ``ln_gemm``, ``attention_nb``
   and ``proj_mlp``) at ViT-B/32's layer, batch 128: each training forward
   against its plain version, chained as the layer chains them; each
   backward fed its forward's residuals against the plain backward, twice
   bit for bit; times beside the bf16 library compositions and the bounds.
17. short attention (explicit use only): its public op under autograd once
   (its path), then its kernels at SHORT_SHAPES against the plain versions,
   the backward twice bit for bit, timed beside SDPA and the flash kernels.
18. ViT-B/32 @256 with ``fused_attention="hybrid"``, serving (3 requests of
   128) and training (batch 128) as phases 5 and 7: 6 launches each of
   ``ln_gemm``, ``attention_nb`` and ``proj_mlp`` per forward, of their
   backwards per step, none of the block kernels; then the two B/32 tiers'
   step times side by side.
19. the blocks past 512 tokens, on the mha route (mha_fwd, mha_bwd,
   mha_dbias): first its path, every counter from 0, the unbiased block at
   ViT-B/16@384's shape and the biased one at the small-dataset ViT's at 384
   px (577 tokens, batch 16, a learned per-head bias, so dbias too) under
   autograd, forward and backward once; then phases 3, 4 and 8 at those
   shapes (LSA's mask, a shared and a per-head bias), each route counter
   checked; then the biased block at 197 tokens (LSA's mask, batch 64) timed
   on both routes, forward and backward: the evidence for the 512-token
   threshold with a bias.
20. profile: ``torch.profiler`` over train steps at seven training configs
   (B/32 on both tiers, CvT-13 at 224 and 384); device time and launches per
   step by kernel group,
   idle share, the host's enqueue time per step and the synchronising calls
   in a step.

Each main path (short attention; serving B/16, B/32, small-dataset, B/32
hybrid, CvT-13 @224 and @384, ScalableViT; training B/32, B/32 hybrid, B/16,
small-dataset, CvT-13 @224 and @384, ScalableViT; the blocks past 512
tokens) runs with every kernel's launch counter set to 0 just before it and
read just after, and each counter must move on one of them; the attention
block's routes are counted each way (short_fwd / short_bwd on the ViTs'
blocks, the small-dataset ViT's biased one too; mha_fwd / mha_bwd past 512
tokens).  The line before the last is the card as ``nvidia-smi`` names it; before that a
JSON line with each kernel's launches (over the main paths, and per path),
error, times and bound (the kernels rebuilt on wgmma and TMA also name their
``design``), after a line that cites the earlier designs' times from PERF.md,
constants that this run did not measure.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

B16 = dict(image_size=224, patch_size=16, num_classes=1000, dim=768, depth=12,
           heads=12, mlp_dim=3072)
ENTRY = dict(image_size=256, patch_size=32, num_classes=1000, dim=1024, depth=6,
             heads=16, mlp_dim=2048)
# vit_for_small_dataset.ViT as benchmarks/run_benchmarks.py:149-151 ran it: n=257.
SMALL_DATASET = dict(image_size=256, patch_size=16, num_classes=1000, dim=1024, depth=6,
                     heads=16, mlp_dim=2048)
# CvT-13, vit_tpu's CvT defaults, as benchmarks/run_benchmarks.py:91 builds
# it; served and trained at 224 px (the JAX package's config) and at 384 px
# (the CvT paper's CvT-13↑384 fine-tuning resolution).
CVT13 = dict(num_classes=1000)
# Kernel against its plain version on the same bf16 inputs, for a residual
# block y = T(x + T(f(x))): both round at the same points and differ by f32
# summation order, which can flip a rounding of an intermediate by one bf16
# unit.  So each element may differ by one bf16 unit of y (the final add,
# where the residual x ~ N(0, 1) makes a unit up to 0.03) plus 2e-2 of the
# block's own output max|ref - x| (a few bf16 units of f(x)).
KERNEL_REL_TOL = 2e-2
# Kernel path against the plain module path through the whole model: the
# plain path rounds elsewhere (fc1 output before GELU, bf16-stored softmax
# logits and probabilities), and the differences compound over depth; a
# tenth of the largest logit still catches a wrong kernel, which gives
# errors of the order of the logits themselves.
LOGIT_REL_TOL = 1e-1
# Against the f32 reference (the same bf16 weights, plain path, in f32) the
# kernel path may deviate at most this many times as far as the plain bf16
# path does, and must agree with it on top-1 at least as often as it.  Top-1
# against the plain bf16 path over all images is printed, not held to a
# fixed share:
# with random weights the 1000 logits' top-2 margin (median 0.079 at B/16) is
# of the order of the bf16 noise of either path (max 0.04 against f32), and
# the plain bf16 path itself agrees with its f32 version on only 93% of top-1s
# (measured on an H100 80GB HBM3 at a 700 W limit).  It is held to
# TOP1_CONFIDENT over the confident images: those whose f32 top-2 margin is
# above twice the plain bf16 path's largest logit error, which that path's
# noise cannot flip.
MAX_ERR_VS_PLAIN_BF16 = 2.0
TOP1_CONFIDENT = 0.99
# Where the plain path is not the kernel path's like in bf16 (the
# small-dataset ViT, whose plain LSA keeps an exact f32 softmax that the
# kernel route, like vit_tpu's, does not), top-1 against f32 is held by a
# sign test instead: over the images where exactly one of the two paths
# agrees with f32's top-1, each is as likely to be that one when the two are
# equally accurate, so plain_only - kernel_only <= 2.33·sqrt(plain_only +
# kernel_only) holds with 99 % probability.  On its random weights (median
# f32 top-2 margin 0.045) the kernel path agreed with f32 on 91.1 % of 192
# images, the plain path on 93.2 % (H100 80GB HBM3, 700 W).
SIGN_TEST_Z = 2.33
# Training: at step 1, each parameter's gradient on the kernel path may be at
# most this many times as far (relative L2) from the f32 model's as the plain
# bf16 path's is; the two paths' first losses agree within LOSS_REL_TOL.
MAX_GRAD_ERR_VS_PLAIN_BF16 = 2.0
LOSS_REL_TOL = 1e-2
# Each tensor is held on its own, except the 0-d ones (LSA's one temperature
# per layer): they are held as one (depth,) vector, the stack of them across
# layers, and each on its own by check_temperatures.
# A temperature's gradient is Σ dWq⊙Wq over the q-third of to_qkv (rows
# [:inner]), a sum of 1M products that nearly cancels in some layers, so its
# relative error can be of any size on a bf16 route: 0.75 on the kernel route
# against the plain path's 0.038 in one layer of six, where the f32 gradient
# was 1/20 of the others' (H100 80GB HBM3, 700 W).  So each temperature's
# error is held to TEMPERATURE_TERMS_TOL·Σ|dWq⊙Wq| (the f32 model's dWq):
# one bf16 unit of every term, all rounded the same way.  A fold that loses
# the exp(temperature) factor or the q-third's gradient misses it in every
# layer whose gradient is not itself below that bound.
TEMPERATURE_TERMS_TOL = 2.0 ** -8
# dbias (f32) against its plain version: both sum the same f32 terms
# p·(dp - dsum), from the same bf16 inputs, in another order, over the images
# (and the heads); the only rounding that can differ is that of doattn =
# T(dy·Wo), where a flip moves one term by a few parts in 1e4.  1e-3 of
# max|ref| leaves a wide margin over that and still catches a bias missing
# from one of the recomputed softmaxes, which moves dbias by the order of
# max|ref|.
DBIAS_REL_TOL = 1e-3
# Flash kernel against its plain version on the same bf16 inputs: both round
# P (and in the backward ds and p) to bf16, the kernel against its key tile's
# running max, the plain version against the row's max, and they sum in
# another order, so a rounding of a P element may differ by one unit.  Summed
# over hundreds of keys with random signs, that stays a few bf16 units of the
# output: each element of out, dq, dk and dv may differ by one unit of its
# dtype plus KERNEL_REL_TOL·max|ref| (check_outputs with no residual).  A
# kernel that drops the ragged-key mask, the running rescale or the scale
# misses that, or LSE_ABS_TOL: lse is f32 on both sides, from the same bf16
# products, and differs only by f32 summation order (1e-6); a key past n_k
# left in the sum moves it by 1e-2 and more.
LSE_ABS_TOL = 1e-3
TRAIN_STEPS = 4
# The H100 SXM's dense bf16 tensor-core peak and memory rate (NVIDIA's data
# sheet, at the full 700 W), for each kernel's bound.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


WALL = {}  # wall seconds of each phase of main(), printed before the kernels' line
STEP_MS = {}  # median step ms of each training path: {tag: {"kernels": ms, "plain": ms}}


@contextlib.contextmanager
def clock(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        WALL[label] = round(time.perf_counter() - t0, 2)


def interleaved_medians(torch, fns: dict, rounds: int, calls: int, warmup: int = 3) -> dict:
    """Median device ms per call of each fn: CUDA events around ``calls``
    back-to-back calls, so the host's enqueue overlaps the device; ``rounds``
    rounds taken in turns, so that clock drift hits every fn alike, after
    ``warmup`` calls of each."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    samples = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            samples[k].append(start.elapsed_time(end) / calls)
    return {k: statistics.median(v) for k, v in samples.items()}


def launch_breakdown(torch, fn, calls: int = 5) -> dict:
    """The device kernels one call of ``fn`` launches, by ``kernel_group``:
    ``{group: (device ms a call, launches a call)}``, from torch.profiler
    over ``calls`` calls after one of warm-up.  A profile can miss its first
    kernels, so it opens with four of ``torch.cuda._sleep``'s spin kernels,
    left out of the count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            torch.cuda._sleep(1000)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in evt.key:
            ms, count = rows.get(kernel_group(evt.key), (0.0, 0.0))
            rows[kernel_group(evt.key)] = (ms + evt.self_device_time_total / 1e3 / calls,
                                           count + evt.count / calls)
    return rows


def check_ln_epilogue(torch, name, fn, banned=()):
    """The device kernels of one call of a backward whose LayerNorm backward
    is the dgrad's epilogue (``gemm_wgmma.cu``'s kEpiLnBwd, at the widths of
    ``ln_bwd_fused``), by :func:`launch_breakdown`: raises unless it launches
    that instance once and neither of ``layernorm.cu``'s backward passes, nor
    a kernel whose group starts with one of ``banned``.  Returns the
    breakdown and the call's device ms."""
    rows = launch_breakdown(torch, fn)
    launches = rows.get(LN_EPILOGUE, (0.0, 0.0))[1]
    bad = [g for g in rows if g in LN_PASSES or g.startswith(tuple(banned))]
    if round(launches) != 1 or bad:
        raise AssertionError(f"{name}: {launches:g} launches of {LN_EPILOGUE} a call (1 "
                             f"expected) and {bad}: {rows}")
    return rows, sum(ms for ms, _ in rows.values())


def ln_library(torch, dxn32, x, gamma, eps):
    """One ``torch.ops.aten.native_layer_norm_backward`` over the f32 dxn
    ``(rows, d)`` with x and gamma in f32: PyTorch's call for the LayerNorm
    backward the epilogue computes (dx_ln, dγ, dβ), the statistics made once
    outside it."""
    d = x.shape[-1]
    x32, g32 = x.reshape(-1, d).float(), gamma.float()
    b32 = torch.zeros_like(g32)
    _, mean, rstd = torch.ops.aten.native_layer_norm(x32, [d], g32, b32, eps)
    return lambda: torch.ops.aten.native_layer_norm_backward(dxn32, x32, [d], mean, rstd, g32,
                                                             b32, [True, True, True])


def block_error(torch, out, ref, x):
    """``(max|out - ref|, excess, tol)`` for a residual block's kernel output
    ``out`` against its plain version ``ref`` on input ``x``: ``excess`` is
    the largest amount by which an element differs beyond one unit of the
    output dtype (the final residual add's rounding), and must not pass
    ``tol`` = KERNEL_REL_TOL·max|ref - x|, a few units of the block's own
    output."""
    diff = (out.float() - ref.float()).abs()
    _, exp = torch.frexp(torch.maximum(out.float().abs(), ref.float().abs()))
    unit = torch.ldexp(torch.full_like(diff, torch.finfo(out.dtype).eps), exp - 1)
    excess = (diff - unit).clamp_min(0).max().item()
    tol = KERNEL_REL_TOL * (ref.float() - x.float()).abs().max().item()
    return diff.max().item(), excess, tol


def check_outputs(torch, name, out, ref, residuals):
    """Hold a kernel's outputs ``out`` against its plain version's ``ref``,
    output by output, with :func:`block_error`: an output that adds a
    residual (``residuals[i]``: x for a block's y, dy for dx) is held to 2e-2
    of its own part, the others to 2e-2·max|ref|, each beyond one unit of
    its dtype.  Returns the largest error; raises on a miss."""
    worst = 0.0
    for i, (o, r) in enumerate(zip(out, ref)):
        if o.shape != r.shape or o.dtype != r.dtype or not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{name} output {i}: {tuple(o.shape)} {o.dtype}, "
                                 f"expected {tuple(r.shape)} {r.dtype}, finite")
        base = residuals.get(i, torch.zeros_like(r))
        err, excess, tol = block_error(torch, o, r, base)
        if not excess <= tol:
            raise AssertionError(f"{name} output {i} differs from its plain version by "
                                 f"{excess} beyond one unit > {tol}")
        worst = max(worst, err)
    return worst


def check_dbias(torch, name, out, ref, what="dbias"):
    """Hold a kernel's f32 sum over the batch (``what``: dbias, or the cross-
    attention block's dbo) against its plain version's within
    DBIAS_REL_TOL·max|ref|; returns max|out - ref|, raises on a miss."""
    if out.shape != ref.shape or out.dtype != ref.dtype or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name} {what}: {tuple(out.shape)} {out.dtype}, expected "
                             f"{tuple(ref.shape)} {ref.dtype}, finite")
    err = (out - ref).abs().max().item()
    tol = DBIAS_REL_TOL * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name} {what} differs from its plain version by {err} > {tol}")
    return err


def bound(flops, nbytes):
    """The least time in ms the card could take: the larger of the FLOPs at
    the bf16 peak and the bytes at the memory rate; and which bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def block_bounds(b, n, d, heads, dim_head, hidden, hb=0, dbias=False):
    """Bounds of the four kernels at one block shape (bf16 activations and
    weights, f32 parameter-gradient sums): FLOPs of the TPU kernels' own
    work; each input read once and each output written once.  With an f32
    ``(hb, n, n)`` logits bias (hb > 0) the attention block's entries read
    it too, and the backward writes dbias when ``dbias``; the bias adds and
    dbias's sums are not tensor-core work."""
    rows, inner = b * n, heads * dim_head
    attn = 2 * b * heads * n * n * dim_head  # one n x n x dim_head product
    act = rows * d * 2  # one (rows, d) bf16 tensor
    bias = 4 * hb * n * n
    return {
        # x, γ, β, W1, b1, W2, b2 -> y
        "fused_mlp": bound(4 * rows * d * hidden,
                           2 * act + 4 * d * hidden + 2 * (3 * d + hidden)),
        # dy, x, h, γ, W1, W2 -> dx, dh, gact and f32 dγ, dβ, db1, db2
        "fused_mlp_bwd": bound(4 * rows * d * hidden,
                               3 * act + 3 * rows * hidden * 2 + 4 * d * hidden
                               + 2 * d + 4 * (3 * d + hidden)),
        # x, γ, β, Wqkv, Wo, bo -> y
        "fused_attention_block": bound(8 * rows * d * inner + 2 * attn,
                                       2 * act + 8 * d * inner + 6 * d + bias),
        # dy, x, qkv, γ, Wqkv, Wo (, bias) -> dx, dqkv and f32 dγ, dβ, dbo (, dbias)
        "fused_attention_block_bwd": bound(8 * rows * d * inner + 5 * attn,
                                           3 * act + 2 * rows * 3 * inner * 2
                                           + 8 * d * inner + 2 * d + 12 * d
                                           + bias * (2 if dbias else 1)),
    }


def kernel_phase(torch, tag, b, n, d, heads, dim_head, hidden, results):
    """The serving forwards of the fused MLP and the attention block at one
    shape, seeded bf16 inputs: each against its plain version (the block on
    the short route also against that route's own plain version), twice bit
    for bit, the block's route counted; times of the kernel, its plain
    version and the bf16 modules."""
    from vit_tpu_torch.layers.common import MLP, Attention, LayerNorm
    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops.fused_attention_block import (
        fused_attention_block, fused_attention_block_reference,
    )
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(1)
    inner = heads * dim_head

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = rn(b, n, d).to(dt)
    gamma, beta = (1.0 + rn(d, scale=0.1)).to(dt), rn(d, scale=0.1).to(dt)
    mlp_w = (rn(hidden, d, scale=d ** -0.5).to(dt), rn(hidden, scale=0.1).to(dt),
             rn(d, hidden, scale=hidden ** -0.5).to(dt), rn(d, scale=0.1).to(dt))
    attn_w = (rn(3 * inner, d, scale=d ** -0.5).to(dt),
              rn(d, inner, scale=inner ** -0.5).to(dt), rn(d, scale=0.1).to(dt))

    norm = LayerNorm(d, device=dev, dtype=dt)
    mlp = MLP(d, hidden, device=dev, dtype=dt)
    attn = Attention(d, heads, dim_head, device=dev, dtype=dt)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
        for p, w in zip((mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias), mlp_w):
            p.copy_(w)
        for p, w in zip((attn.to_qkv.weight, attn.to_out[0].weight, attn.to_out[0].bias), attn_w):
            p.copy_(w)
    norm.eval(), mlp.eval(), attn.eval()

    route = fab.attention_route(n)
    cases = {
        "fused_mlp": (fused_mlp,
                      lambda: fused_mlp(x, gamma, beta, *mlp_w),
                      lambda: fused_mlp_reference(x, gamma, beta, *mlp_w),
                      lambda: x + mlp(norm(x)), None),
        "fused_attention_block": (
            fused_attention_block,
            lambda: fused_attention_block(x, gamma, beta, *attn_w, heads, dim_head),
            lambda: fused_attention_block_reference(x, gamma, beta, *attn_w, heads,
                                                    dim_head),
            lambda: x + attn(norm(x)),
            (lambda: fab.fused_attention_block_short_forward_reference(
                x, gamma, beta, *attn_w, heads, dim_head)[0]) if route == "short" else None),
    }
    with torch.inference_mode():
        for name, (wrapper, kernel, plain, modules, own_plain) in cases.items():
            before, routes = wrapper.launches, fab.FORWARD_ROUTES[route].launches
            out = kernel()
            torch.cuda.synchronize()
            if wrapper.launches != before + 1:
                raise AssertionError(f"{name}: launch counter did not move")
            if name == "fused_attention_block" and \
                    fab.FORWARD_ROUTES[route].launches != routes + 1:
                raise AssertionError(f"{name}: the {route} route's counter did not move")
            ref = plain()
            if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
            if not torch.equal(out, kernel()):
                raise AssertionError(f"{name}: two runs differ")
            err, excess, tol = block_error(torch, out, ref, x)
            own = ""
            if own_plain:
                own_err, own_excess, own_tol = block_error(torch, out, own_plain(), x)
                if not own_excess <= own_tol:
                    raise AssertionError(f"{name}: kernel differs from the {route} route's "
                                         f"plain version by {own_excess} > {own_tol}")
                own = (f"; against the {route} route's plain version (p normalised before "
                       f"P·V) {own_err:.6g}, beyond one unit {own_excess:.6g}")
            ms = interleaved_medians(torch, {"kernel": kernel, "plain": plain,
                                             "modules": modules}, rounds=5, calls=10)
            via = f", attention on the {route} route" if wrapper is fused_attention_block else ""
            log(f"kernel {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} "
                f"h={hidden}{via}]: max|kernel-plain|={err:.6g}, beyond one bf16 unit of "
                f"the output {excess:.6g} tol={tol:.6g} (2e-2*max|ref-x|: a few bf16 "
                f"units of the block's own output){own}; the same bits in two runs; ms "
                f"kernel={ms['kernel']:.4f} plain={ms['plain']:.4f} "
                f"modules={ms['modules']:.4f}")
            if not excess <= tol:
                raise AssertionError(f"{name}: kernel differs from its plain version "
                                     f"by {excess} beyond one output unit > {tol}")
            results.setdefault(name, {})[tag] = dict(
                err=err, **ms, bound=block_bounds(b, n, d, heads, dim_head, hidden)[name])


# The blocks' forward GEMMs (fc1 keeping h, fc2, QKV, out-projection; csrc/
# gemm_wgmma.cu launch_forward_gemm) at the main paths' shapes: (tag, rows, n,
# k, epilogue).  ViT-B/32 @256 at batch 128 (bench.py's step) and 8 (the
# entry's serving), ViT-B/16 @224 at batch 64, and ScalableViT @256's
# conv-MLPs at batch 64 (dim 64 · 2^s, hidden 4x, (64 / 2^s)² tokens an
# image at stage s + 1): the shapes on both sides of the threshold.
FORWARD_GEMM_SHAPES = [
    ("B/32 QKV", 8320, 3072, 1024, "store"),
    ("B/32 out-proj", 8320, 1024, 1024, "bias_residual"),
    ("B/32 fc1", 8320, 2048, 1024, "bias_gelu_save"),
    ("B/32 fc2", 8320, 1024, 2048, "bias_residual"),
    ("B/32 serving fc1, batch 8", 520, 2048, 1024, "bias_gelu"),
    ("B/16 QKV", 12608, 2304, 768, "store"),
    ("B/16 out-proj", 12608, 768, 768, "bias_residual"),
    ("B/16 fc1", 12608, 3072, 768, "bias_gelu_save"),
    ("B/16 fc2", 12608, 768, 3072, "bias_residual"),
    ("ScalableViT stage 1 fc1", 262144, 256, 64, "bias_gelu_save"),
    ("ScalableViT stage 1 fc2", 262144, 64, 256, "bias_residual"),
    ("ScalableViT stage 2 fc1", 65536, 512, 128, "bias_gelu_save"),
    ("ScalableViT stage 2 fc2", 65536, 128, 512, "bias_residual"),
    ("ScalableViT stage 3 fc1", 16384, 1024, 256, "bias_gelu_save"),
    ("ScalableViT stage 3 fc2", 16384, 256, 1024, "bias_residual"),
    ("ScalableViT stage 4 fc1", 4096, 2048, 512, "bias_gelu_save"),
    ("ScalableViT stage 4 fc2", 4096, 512, 2048, "bias_residual"),
]
FORWARD_GEMM_MIN_N = 256  # csrc/gemm_wgmma.cu kForwardMinN: launch_forward_gemm's rule


def gemm_bound(rows, n, k, epilogue):
    """Bound of one forward GEMM (bf16): 2·rows·n·k FLOPs; A and W read, the
    bias and the residual read as the epilogue takes them, out (and h for
    ``bias_gelu_save``) written."""
    outs = 2 if epilogue == "bias_gelu_save" else 1
    nbytes = 2 * (rows * k + n * k + outs * rows * n)
    if epilogue != "store":
        nbytes += 2 * n
    if epilogue == "bias_residual":
        nbytes += 2 * rows * n
    return bound(2 * rows * n * k, nbytes)


def forward_gemm_phase(torch, smi):
    """The blocks' forward GEMMs at FORWARD_GEMM_SHAPES on both kernels that
    launch_forward_gemm chooses between: gemm_wgmma.cu's wgmma GEMM and
    linear.cu's mma.sync one (``fused_hybrid.gemm_wgmma(kernel=...)``),
    seeded bf16 inputs.  Each output against the plain GEMM (one unit plus
    2e-2 of its own part, the residual's part apart); times of both kernels
    in turns, the bound, and which one the rule (n >= FORWARD_GEMM_MIN_N on
    gemm_wgmma) takes.  Returns ``{tag: {wgmma, mma_sync, bound}}`` ms."""
    from vit_tpu_torch.ops import fused_hybrid as fh

    dev, dt = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(21)
    out = {}
    for tag, rows, n, k, epilogue in FORWARD_GEMM_SHAPES:
        a = torch.randn(rows, k, generator=g, device=dev).to(dt)
        w = (torch.randn(n, k, generator=g, device=dev) * k ** -0.5).to(dt)
        bias = (torch.randn(n, generator=g, device=dev) * 0.1).to(dt)
        res = torch.randn(rows, n, generator=g, device=dev).to(dt) \
            if epilogue == "bias_residual" else None
        ref = fh.gemm_reference(a, w, epilogue, bias, res)
        ref = tuple(t for t in ref if t is not None)
        fns = {}
        for kernel in fh.GEMM_KERNELS:
            def fn(kernel=kernel):
                return fh.gemm_wgmma(a, w, epilogue, bias, res, kernel=kernel)

            got = tuple(t for t in fn() if t is not None)
            check_outputs(torch, f"forward GEMM {tag} on {kernel}", got, ref,
                          {0: res} if res is not None else {})
            fns[kernel] = fn
        ms = interleaved_medians(torch, fns, rounds=5, calls=10)
        limit, by = gemm_bound(rows, n, k, epilogue)
        takes = "wgmma" if n >= FORWARD_GEMM_MIN_N else "mma_sync"
        log(f"forward GEMM {tag} [rows={rows} n={n} k={k} {epilogue}]: ms gemm_wgmma="
            f"{ms['wgmma']:.4f} linear.cu mma.sync={ms['mma_sync']:.4f} bound={limit:.4f} "
            f"({by}); launch_forward_gemm takes {takes}; both within one unit plus 2e-2 of "
            f"the plain GEMM, on {smi}")
        out[tag] = dict(ms, bound=limit, takes=takes)
        del a, w, res, ref, fns
    return out


def backward_phase(torch, tag, b, n, d, heads, dim_head, hidden, results):
    """At a training shape, from seeded bf16 inputs and cotangent: each
    training forward (the kernels that keep the residuals, as under grad)
    against its plain version, output by output, twice bit for bit, the
    block's lse (kept for the short route of its backward) within
    LSE_ABS_TOL; then each backward kernel, fed the residuals the forward
    kernels kept, against its plain backward on the same residuals, and twice
    bit for bit (the block's attention on the route ``attention_route`` gives
    it, as in training).  Times of the backward kernel, its plain version, the
    kernel with the two weight-gradient GEMMs (the op's whole backward), and
    PyTorch autograd through the plain bf16 modules, once for the kernel's
    own outputs (dx and the γ, β and bias gradients) and once with the weight
    gradients too."""
    from vit_tpu_torch.layers.common import MLP, Attention, LayerNorm
    from vit_tpu_torch.ops import _build, fused_attention_block as fab, fused_mlp as fm
    from vit_tpu_torch.ops import fused_hybrid as fh
    from vit_tpu_torch.ops._shared import weight_grad

    dev, dt, eps = torch.device("cuda"), torch.bfloat16, 1e-3
    g = torch.Generator(device=dev).manual_seed(3)
    inner = heads * dim_head

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
    gamma, beta = (1.0 + rn(d, scale=0.1).float()).to(dt), rn(d, scale=0.1)
    mlp_w = (rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1),
             rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1))
    attn_w = (rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5),
              rn(d, scale=0.1))
    w1, _, w2, _ = mlp_w
    wqkv, wo, _ = attn_w
    scale = dim_head ** -0.5

    # The training forwards and the residuals they keep (the block's lse for
    # the short route of its backward, where that route applies).
    route = fab.attention_route(n)

    def mlp_forward():
        return fm._launch_forward(x, gamma, beta, *mlp_w, eps, save_residuals=True)

    def attn_forward():
        return fab._launch_forward(x, gamma, beta, *attn_w, heads, dim_head, scale, eps,
                                   training=True)

    attn_fwd = attn_forward()
    fwd = {
        "fused_mlp": (mlp_forward, mlp_forward(),
                      fm.fused_mlp_forward_reference(x, gamma, beta, *mlp_w, eps),
                      "y, xn, h"),
        "fused_attention_block": (
            lambda: attn_forward()[:4], attn_fwd[:4],
            fab.fused_attention_block_forward_reference(x, gamma, beta, *attn_w, heads,
                                                        dim_head, scale, eps),
            f"y, xn, qkv, oattn; attention on the {route} route"),
    }
    torch.cuda.synchronize()
    for name, (again, out, ref, outputs) in fwd.items():
        err = check_outputs(torch, f"{name} training forward", out, ref, {0: x})
        if not all(torch.equal(a, b_) for a, b_ in zip(out, again())):
            raise AssertionError(f"{name} training forward: two runs differ")
        log(f"training forward {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} "
            f"h={hidden}]: ({outputs}) each within one bf16 unit plus 2e-2*max|its own "
            f"part| of the plain version, the same bits in two runs; "
            f"max|kernel-plain|={err:.6g}")
        results.setdefault(name, {}).setdefault(tag, {})["train_fwd_err"] = err
    _, xn_m, h = fwd["fused_mlp"][1]
    _, xn_a, qkv, oattn, lse = attn_fwd
    if lse is not None:  # f32 on both sides, from the same bf16 qkv: summation order only
        lse_err = (lse - fab.attention_lse_reference(qkv, heads, dim_head, scale)).abs().max()
        if not lse_err.item() <= LSE_ABS_TOL:
            raise AssertionError(f"fused_attention_block training forward lse differs from its "
                                 f"plain version by {lse_err.item()} > {LSE_ABS_TOL}")

    norm = LayerNorm(d, device=dev, dtype=dt)
    mlp = MLP(d, hidden, device=dev, dtype=dt)
    attn = Attention(d, heads, dim_head, device=dev, dtype=dt)
    with torch.no_grad():
        for prm, w in zip((norm.weight, norm.bias, mlp.fc1.weight, mlp.fc1.bias,
                           mlp.fc2.weight, mlp.fc2.bias, attn.to_qkv.weight,
                           attn.to_out[0].weight, attn.to_out[0].bias),
                          (gamma, beta, *mlp_w, *attn_w)):
            prm.copy_(w)
    xg = x.detach().requires_grad_()

    def autograd_through(module, weights):
        y = xg + module(norm(xg))
        inputs = [xg, *norm.parameters(), *(prm for key, prm in module.named_parameters()
                                            if weights or key.endswith("bias"))]
        return lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True)

    def mlp_kernel():
        return fm.fused_mlp_backward(dy, x, h, gamma, w1, w2, eps)

    def mlp_whole():
        out = mlp_kernel()
        return out, weight_grad(out[1], xn_m), weight_grad(dy, out[2])

    def attn_kernel():
        return fab.fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads,
                                                  dim_head, scale, eps, oattn, lse)

    def attn_whole():
        out = attn_kernel()
        return out, weight_grad(out[1], xn_a), weight_grad(dy, oattn)

    cases = {
        "fused_mlp_bwd": (fm.fused_mlp_backward, mlp_kernel,
                          lambda: fm.fused_mlp_backward_reference(dy, x, h, gamma, w1, w2, eps),
                          mlp_whole, mlp, w1),
        "fused_attention_block_bwd": (
            fab.fused_attention_block_backward, attn_kernel,
            lambda: fab.fused_attention_block_backward_reference(
                dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps),
            attn_whole, attn, wqkv),
    }
    for name, (wrapper, kernel, plain, whole, module, w_ln) in cases.items():
        before, routes = wrapper.launches, fab.BACKWARD_ROUTES[route].launches
        out = kernel()
        torch.cuda.synchronize()
        if wrapper.launches != before + 1:
            raise AssertionError(f"{name}: launch counter did not move")
        if name == "fused_attention_block_bwd" and \
                fab.BACKWARD_ROUTES[route].launches != routes + 1:
            raise AssertionError(f"{name}: the {route} route's counter did not move")
        err = check_outputs(torch, name, out, plain(), {0: dy})
        if not all(torch.equal(a, b_) for a, b_ in zip(out, kernel())):
            raise AssertionError(f"{name}: two runs differ")
        # Its LayerNorm backward is the dgrad's epilogue: no f32 dxn, no
        # layernorm.cu passes; PyTorch's LayerNorm backward timed on the
        # f32 dxn it keeps on chip (dh·W1 or dqkv·Wqkv, from its own output).
        rows, device = check_ln_epilogue(torch, name, kernel)
        grad_in = out[1].reshape(-1, out[1].shape[-1])
        dxn32 = fh.gemm_wgmma(grad_in, w_ln, "f32", layout="kn")[0]
        ms = interleaved_medians(torch, {
            "kernel": kernel, "plain": plain, "whole": whole,
            "library": autograd_through(module, weights=False),
            "library_whole": autograd_through(module, weights=True),
            "library_ln": ln_library(torch, dxn32, x, gamma, eps)}, rounds=5, calls=5)
        del dxn32
        limit, by = block_bounds(b, n, d, heads, dim_head, hidden)[name]
        via = f", attention on the {route} route" if name == "fused_attention_block_bwd" else ""
        log(f"backward {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} h={hidden}]: "
            f"fed the forward kernel's residuals{via}; max|kernel-plain| over the outputs="
            f"{err:.6g}, each within one unit plus 2e-2*max|its own part|, the same bits in two "
            f"runs; ms kernel={ms['kernel']:.4f} "
            f"plain={ms['plain']:.4f} autograd through the bf16 modules for the same outputs="
            f"{ms['library']:.4f}; with the weight gradients: kernel+dW GEMMs="
            f"{ms['whole']:.4f} autograd={ms['library_whole']:.4f}; bound={limit:.4f} ({by}); "
            f"device ms a call {device:.4f}, of it the LayerNorm-backward dgrad "
            f"{rows[LN_EPILOGUE][0]:.4f} on {_build.load().vit_ln_bwd_clusters(d)} clusters of "
            f"{d // 256} CTAs (no {' or '.join(LN_PASSES)}); "
            f"native_layer_norm_backward on the same f32 dxn={ms['library_ln']:.4f}")
        results.setdefault(name, {})[tag] = dict(err=err, **ms, device=device,
                                                 bound=(limit, by))


def biased_phase(torch, b, n, d, heads, dim_head, hidden, results, tag=None):
    """The biased block at the small-dataset ViT's shapes, for LSA's mask
    (scale 1.0, no dbias), a shared and a per-head random bias, on the route
    ``attention_route`` gives it (short_fwd / short_bwd with the bias up to
    512 tokens, counted): serving and training forwards (lse within
    LSE_ABS_TOL), backward fed the training forward's residuals (dbias within
    DBIAS_REL_TOL), each against the TPU kernel's rounding points and against
    the route's own plain version, twice bit for bit; times beside the
    unbiased kernel on the same inputs and the bf16 modules with
    ``scaled_dot_product_attention``.  dbias is held to the route's own
    plain version; on the short route its distance from the TPU kernel's
    rounding points is printed beside, with that between the two plain
    versions, and not held: D = rowsum(dO∘O) for dsum, which O's rounding to
    bf16 moves, takes a per-head dbias past DBIAS_REL_TOL at some inputs
    (ROADMAP.md's traps).  Results go under the bias's kind, with ``, tag``
    after it when given (another shape)."""
    import torch.nn.functional as F

    from vit_tpu_torch.layers.common import Attention, LayerNorm
    from vit_tpu_torch.models.vit_for_small_dataset import lsa_bias
    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops._shared import weight_grad

    dev, dt, eps = torch.device("cuda"), torch.bfloat16, 1e-3
    g = torch.Generator(device=dev).manual_seed(11)
    inner = heads * dim_head

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
    gamma, beta = (1.0 + rn(d, scale=0.1).float()).to(dt), rn(d, scale=0.1)
    wqkv, wo, bo = rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5), \
        rn(d, scale=0.1)
    args = (x, gamma, beta, wqkv, wo, bo)
    norm = LayerNorm(d, device=dev, dtype=dt)
    attn = Attention(d, heads, dim_head, device=dev, dtype=dt)
    with torch.no_grad():
        for prm, w in zip((norm.weight, norm.bias, attn.to_qkv.weight, attn.to_out[0].weight,
                           attn.to_out[0].bias), (gamma, beta, wqkv, wo, bo)):
            prm.copy_(w)
    xg = x.detach().requires_grad_()
    route = fab.attention_route(n)
    short = route == "short"
    kinds = {"lsa": (lsa_bias(n, dev), 1.0),
             "shared": (torch.randn(1, n, n, generator=g, device=dev) * 0.5, dim_head ** -0.5),
             "per-head": (torch.randn(heads, n, n, generator=g, device=dev) * 0.5,
                          dim_head ** -0.5)}
    for kind, (bias, scale) in kinds.items():
        want_dbias = kind != "lsa"
        shape = f"[{kind} bias {tuple(bias.shape)}, scale {scale:.4g}, b={b} n={n} d={d} " \
                f"heads={heads}x{dim_head}]"

        def modules(mask):
            """The block in bf16 modules, attention by PyTorch's SDPA."""
            q, k, v = (t.reshape(b, n, heads, dim_head).transpose(1, 2)
                       for t in attn.to_qkv(norm(xg)).chunk(3, dim=-1))
            o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)
            return xg + attn.to_out[0](o.transpose(1, 2).reshape(b, n, inner))

        mask = bias.to(dt)
        with torch.inference_mode():
            before = fab.fused_attention_block_bias.launches
            routes = fab.FORWARD_ROUTES[route].launches
            out = fab.fused_attention_block_bias(*args, bias, heads, dim_head, scale, eps)
            torch.cuda.synchronize()
            if fab.fused_attention_block_bias.launches != before + 1:
                raise AssertionError(f"biased forward {kind}: launch counter did not move")
            if fab.FORWARD_ROUTES[route].launches != routes + 1:
                raise AssertionError(f"biased forward {kind}: the {route} route's counter did "
                                     f"not move")
            ref = fab.fused_attention_block_reference(*args, heads, dim_head, scale, eps, bias)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"biased forward {kind}: non-finite output")
            err, excess, tol = block_error(torch, out, ref, x)
            if not excess <= tol:
                raise AssertionError(f"biased forward {kind}: differs from its plain version "
                                     f"by {excess} beyond one output unit > {tol}")
            if not torch.equal(out, fab.fused_attention_block_bias(*args, bias, heads, dim_head,
                                                                   scale, eps)):
                raise AssertionError(f"biased forward {kind}: two runs differ")
            own_err = 0.0
            if short:  # the short route's own plain version (its rounding points)
                own_err, own_excess, own_tol = block_error(
                    torch, out, fab.fused_attention_block_short_forward_reference(
                        *args, heads, dim_head, scale, eps, bias)[0], x)
                if not own_excess <= own_tol:
                    raise AssertionError(f"biased forward {kind}: differs from the short "
                                         f"route's plain version by {own_excess} > {own_tol}")
            fwd_ms = interleaved_medians(torch, {
                "kernel": lambda: fab.fused_attention_block_bias(*args, bias, heads, dim_head,
                                                                 scale, eps),
                "unbiased": lambda: fab.fused_attention_block(*args, heads, dim_head, scale, eps),
                "plain": lambda: fab.fused_attention_block_reference(*args, heads, dim_head,
                                                                     scale, eps, bias),
                "library": lambda: modules(mask)}, rounds=5, calls=10)
        train = fab._launch_forward(*args, heads, dim_head, scale, eps, bias, training=True)
        train_err = check_outputs(
            torch, f"biased training forward {kind}", train[:4],
            fab.fused_attention_block_forward_reference(*args, heads, dim_head, scale, eps,
                                                        bias), {0: x})
        if short:
            train_err = max(train_err, check_outputs(
                torch, f"biased training forward {kind}, short route", train[:4],
                fab.fused_attention_block_short_forward_reference(*args, heads, dim_head, scale,
                                                                  eps, bias)[:4], {0: x}))
        again = fab._launch_forward(*args, heads, dim_head, scale, eps, bias, training=True)
        if not all(torch.equal(a, b_) for a, b_ in zip(train, again) if a is not None):
            raise AssertionError(f"biased training forward {kind}: two runs differ")
        del again
        _, xn, qkv, oattn, lse = train
        lse_err = None
        if short:  # f32 on both sides, from the same bf16 qkv: summation order only
            lse_err = (lse - fab.attention_lse_reference(qkv, heads, dim_head, scale, bias)
                       ).abs().max().item()
            if not lse_err <= LSE_ABS_TOL:
                raise AssertionError(f"biased training forward {kind}: lse differs from its "
                                     f"plain version by {lse_err} > {LSE_ABS_TOL}")
        # The unbiased block on the same inputs, timed beside: its own
        # training forward's residuals, for the route its backward takes.
        unbiased = fab._launch_forward(*args, heads, dim_head, scale, eps, training=True)
        bounds = block_bounds(b, n, d, heads, dim_head, hidden, bias.shape[0], want_dbias)
        fwd_bound = bounds["fused_attention_block"]
        bwd_bound = bounds["fused_attention_block_bwd"]
        log(f"biased forward {shape}, attention on the {route} route: serving "
            f"max|kernel-plain|={err:.6g}, beyond one bf16 unit {excess:.6g} tol={tol:.6g}"
            + (f", against the route's own plain version {own_err:.6g}" if short else "")
            + f"; training forward (y, xn, qkv, oattn) max {train_err:.6g}, lse {lse_err}; the "
            f"same bits in two runs; ms "
            f"kernel={fwd_ms['kernel']:.4f} unbiased kernel on the same "
            f"inputs={fwd_ms['unbiased']:.4f} plain={fwd_ms['plain']:.4f} bf16 modules with "
            f"SDPA(attn_mask=bias)={fwd_ms['library']:.4f}; bound={fwd_bound[0]:.4f} "
            f"({fwd_bound[1]})")

        def kernel():
            return fab.fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias,
                                                           heads, dim_head, scale, eps,
                                                           need_dbias=want_dbias, oattn=oattn,
                                                           lse=lse)

        def whole():
            out = kernel()
            return out, weight_grad(out[1], xn), weight_grad(dy, oattn)

        def plain():
            return fab.fused_attention_block_backward_reference(
                dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps, bias, want_dbias)

        def autograd_through(weights):
            mask_g = mask.detach().requires_grad_(want_dbias)
            y = modules(mask_g)
            inputs = [xg, *norm.parameters(), attn.to_out[0].bias]
            inputs += [mask_g] if want_dbias else []
            inputs += [attn.to_qkv.weight, attn.to_out[0].weight] if weights else []
            return lambda: torch.autograd.grad(y, inputs, dy, retain_graph=True)

        before = fab.fused_attention_block_bias_backward.launches
        routes = fab.BACKWARD_ROUTES[route].launches
        got = kernel()
        torch.cuda.synchronize()
        if fab.fused_attention_block_bias_backward.launches != before + 1:
            raise AssertionError(f"biased backward {kind}: launch counter did not move")
        if fab.BACKWARD_ROUTES[route].launches != routes + 1:
            raise AssertionError(f"biased backward {kind}: the {route} route's counter did not "
                                 f"move")
        tpu = want = plain()  # the TPU kernel's rounding points
        bwd_err = check_outputs(torch, f"biased backward {kind}", got[:5], tpu[:5], {0: dy})
        if short:  # the short route's own plain version: D = rowsum(dO∘O), dbias from it
            want = fab.fused_attention_block_short_backward_reference(
                dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dim_head, scale, eps, bias,
                want_dbias)
            bwd_err = max(bwd_err, check_outputs(torch, f"biased backward {kind}, short route",
                                                 got[:5], want[:5], {0: dy}))
        again = kernel()
        if not all(torch.equal(a, b_) for a, b_ in zip(got[:5], again[:5])):
            raise AssertionError(f"biased backward {kind}: two runs differ")
        dbias_err = dbias_max = dbias_tpu = plain_gap = None
        if want_dbias:
            dbias_err = check_dbias(torch, f"biased backward {kind}", got[5], want[5])
            dbias_max = want[5].abs().max().item()
            tpu_max = tpu[5].abs().max().item()
            dbias_tpu = (got[5] - tpu[5]).abs().max().item() / tpu_max
            plain_gap = (want[5] - tpu[5]).abs().max().item() / tpu_max
            if not torch.equal(got[5], again[5]):
                raise AssertionError(f"biased backward {kind}: dbias differs between two runs")
        elif got[5] is not None:
            raise AssertionError(f"biased backward {kind}: dbias computed unasked")
        del want, tpu, again
        ln_rows, device = check_ln_epilogue(torch, f"biased backward {kind}", kernel)
        bwd_ms = interleaved_medians(torch, {
            "kernel": kernel,
            "unbiased": lambda: fab.fused_attention_block_backward(
                dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps, *unbiased[3:]),
            "plain": plain, "whole": whole, "library": autograd_through(weights=False),
            "library_whole": autograd_through(weights=True)}, rounds=5, calls=5)
        log(f"biased backward {shape}: fed the forward kernel's residuals, attention on the "
            f"{route} route; max|kernel-plain| over (dx, dqkv, dγ, dβ, dbo)={bwd_err:.6g}, each "
            f"within one unit plus 2e-2*max|its own part| of the TPU kernel's rounding points "
            f"and of the route's own plain version, the same bits in two runs; dbias "
            + (f"max|kernel-plain|={dbias_err:.6g} of max|ref|={dbias_max:.6g} (<= "
               f"{DBIAS_REL_TOL}*max|ref|, the route's own plain version), against the TPU "
               f"kernel's rounding points {dbias_tpu:.6g}*max|ref|"
               + (f" (not held: the two plain versions differ by {plain_gap:.6g}*max|ref|, "
                  f"D = rowsum(dO∘O) for dsum)" if short else "")
               + ", the same bits in two runs"
               if want_dbias else "not asked for, not computed")
            + f"; ms kernel={bwd_ms['kernel']:.4f} unbiased kernel on the same inputs="
            f"{bwd_ms['unbiased']:.4f} plain={bwd_ms['plain']:.4f} autograd through the bf16 "
            f"modules with SDPA for the same outputs={bwd_ms['library']:.4f}; with the weight "
            f"gradients: kernel+dW GEMMs={bwd_ms['whole']:.4f} autograd="
            f"{bwd_ms['library_whole']:.4f}; bound={bwd_bound[0]:.4f} ({bwd_bound[1]}); "
            f"device ms a call {device:.4f}, of it the LayerNorm-backward dgrad "
            f"{ln_rows[LN_EPILOGUE][0]:.4f} (no {' or '.join(LN_PASSES)})")
        key = kind if tag is None else f"{kind}, {tag}"
        results.setdefault("fused_attention_block_bias", {})[key] = dict(
            err=max(err, own_err, train_err), lse_err=lse_err, **fwd_ms, bound=fwd_bound)
        results.setdefault("fused_attention_block_bias_bwd", {})[key] = dict(
            err=bwd_err, dbias_err=dbias_err, dbias_vs_tpu_rel=dbias_tpu,
            dbias_plain_gap_rel=plain_gap, **bwd_ms, device=device, bound=bwd_bound)


# The blocks past 512 tokens, on the mha route: ViT-B/16 at 384 px (24² + 1 =
# 577 tokens, the ViT paper's fine-tuning resolution) and the small-dataset ViT
# at 384 px (577 tokens at its width, 16 heads of 64), batch 16: (tag, b, n,
# d, heads, dim_head, hidden).
MHA_SHAPES = [("B/16@384", 16, 577, 768, 12, 64, 3072),
              ("small-dataset@384", 16, 577, 1024, 16, 64, 2048)]
# The biased block below the threshold, where the short route's one key tile
# is widest (208 keys): ViT-B/16's 197 tokens at the small-dataset ViT's width
# with LSA's mask, batch 64: (b, n, d, heads, dim_head).
THRESHOLD_SHAPE = (64, 197, 1024, 16, 64)


def mha_route_phase(torch, results, smi, counters):
    """The attention blocks past 512 tokens, on the mha route (mha_fwd,
    mha_bwd, mha_dbias).  First its path: every counter from 0, the unbiased
    block at MHA_SHAPES[0] and the biased one at MHA_SHAPES[1] with a learned
    per-head bias (so dbias too) under autograd, forward and backward, once
    each; the counters read right after are the phase's launches, and every
    gradient must be finite.  Then the kernels at those shapes as phases 3,
    4 and 8 hold them (each against its plain version, twice bit for bit,
    each route counter checked).  Last, the biased block at THRESHOLD_SHAPE
    on both routes (the route function replaced for the call): y and the
    backward against the plain versions, and the times of each."""
    from unittest import mock

    from vit_tpu_torch.models.vit_for_small_dataset import lsa_bias
    from vit_tpu_torch.ops import fused_attention_block as fab

    dev, dt, eps = torch.device("cuda"), torch.bfloat16, 1e-3
    g = torch.Generator(device=dev).manual_seed(90)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    def block_args(b, n, d, heads, dim_head):
        inner = heads * dim_head
        return [rn(b, n, d), 1.0 + rn(d, scale=0.1), rn(d, scale=0.1),
                rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5),
                rn(d, scale=0.1)]

    (_, b, n, d, heads, dim_head, _), (_, b2, n2, d2, heads2, dim_head2, _) = MHA_SHAPES
    unbiased = [t.requires_grad_() for t in block_args(b, n, d, heads, dim_head)]
    biased = [t.requires_grad_() for t in block_args(b2, n2, d2, heads2, dim_head2)]
    bias = (torch.randn(heads2, n2, n2, generator=g, device=dev) * 0.5).requires_grad_()
    dys = rn(b, n, d, scale=0.1), rn(b2, n2, d2, scale=0.1)
    for c in counters.values():
        c.launches = 0
    fab.fused_attention_block(*unbiased, heads, dim_head).backward(dys[0])
    fab.fused_attention_block_bias(*biased, bias, heads2, dim_head2).backward(dys[1])
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    check_launches("mha route", "one forward and backward of each block", counters, {
        "fused_attention_block": 1, "fused_attention_block_bwd": 1,
        "fused_attention_block_bias": 1, "fused_attention_block_bias_bwd": 1,
        "mha route, forward": 2, "mha route": 2}, 1)
    grads = [t.grad for t in (*unbiased, *biased, bias)]
    if not all(gr is not None and bool(torch.isfinite(gr).all()) for gr in grads):
        raise AssertionError("mha route: a gradient is missing or not finite")
    log(f"mha route: the unbiased block at {MHA_SHAPES[0][0]} (b={b} n={n} d={d} "
        f"heads={heads}x{dim_head}) and the biased one at {MHA_SHAPES[1][0]} (b={b2} n={n2} "
        f"d={d2} heads={heads2}x{dim_head2}, a learned ({heads2}, {n2}, {n2}) bias) under "
        f"autograd: launches {json.dumps({k: v for k, v in launches.items() if v})}, every "
        f"gradient finite, dbias included")
    del unbiased, biased, bias, dys, grads

    tag, b, n, d, heads, dim_head, hidden = MHA_SHAPES[0]
    kernel_phase(torch, tag, b, n, d, heads, dim_head, hidden, results)
    backward_phase(torch, tag, b, n, d, heads, dim_head, hidden, results)
    tag, b, n, d, heads, dim_head, hidden = MHA_SHAPES[1]
    biased_phase(torch, b, n, d, heads, dim_head, hidden, results, tag=tag)
    torch.cuda.empty_cache()

    b, n, d, heads, dim_head = THRESHOLD_SHAPE
    args = block_args(b, n, d, heads, dim_head)
    x, gamma, _, wqkv, wo, _ = args
    bias, scale, dy = lsa_bias(n, dev), 1.0, rn(b, n, d, scale=0.1)

    def on(route, fn):  # fn with the blocks' attention on ``route``
        def run():
            with mock.patch.object(fab, "attention_route", lambda n: route):
                return fn()
        return run

    y_ref = fab.fused_attention_block_reference(*args, heads, dim_head, scale, eps, bias)
    fns = {}
    for route in ("short", "mha"):
        before = fab.FORWARD_ROUTES[route].launches
        out = on(route, lambda: fab.fused_attention_block_bias(*args, bias, heads, dim_head,
                                                               scale, eps))()
        _, _, qkv, oattn, lse = on(route, lambda: fab._launch_forward(
            *args, heads, dim_head, scale, eps, bias, training=True))()
        if fab.FORWARD_ROUTES[route].launches != before + 2:
            raise AssertionError(f"biased block at n={n}: the {route} route was not taken")
        _, excess, tol = block_error(torch, out, y_ref, x)
        if not excess <= tol:
            raise AssertionError(f"biased block at n={n}, {route} route: differs from its plain "
                                 f"version by {excess} beyond one output unit > {tol}")

        def backward(qkv=qkv, oattn=oattn, lse=lse):
            return fab.fused_attention_block_bias_backward(
                dy, x, qkv, gamma, wqkv, wo, bias, heads, dim_head, scale, eps,
                need_dbias=False, oattn=oattn, lse=lse)

        check_outputs(torch, f"biased backward at n={n}, {route} route", on(route, backward)()[:5],
                      fab.fused_attention_block_backward_reference(
                          dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps, bias,
                          need_dbias=False)[:5], {0: dy})
        fns[f"{route} forward"] = on(route, lambda: fab.fused_attention_block_bias(
            *args, bias, heads, dim_head, scale, eps))
        fns[f"{route} backward"] = on(route, backward)
    ms = interleaved_medians(torch, fns, rounds=5, calls=5)
    log(f"biased block on both routes [LSA's mask, scale 1, b={b} n={n} d={d} "
        f"heads={heads}x{dim_head}]: y and the backward (dx, dqkv, dγ, dβ, dbo) on each within "
        f"one unit plus 2e-2*max|its own part| of the plain versions; ms forward "
        f"short={ms['short forward']:.4f} mha={ms['mha forward']:.4f}, backward "
        f"short={ms['short backward']:.4f} mha={ms['mha backward']:.4f} on {smi}")
    results["route threshold"] = {f"n={n}": ms}
    return launches


def spt_phase(torch, batch, size, patch, dim, smi):
    """The small-dataset tokenizer: its convolution form (the model's path)
    against the eager concat → patchify → LN → Dense form, both in bf16, and
    the eager form in f32; the convolution form may be at most twice as far
    from f32 as the eager bf16 form.  Times of both bf16 forms, and of the
    convolution form with cuDNN's TF32 allowed (PyTorch's default, which the
    smoke turns off for its f32 references): its main convolution follows
    the caller's setting, and its 16-bit operands are exact in TF32."""
    from vit_tpu_torch import cast_params
    from vit_tpu_torch.models.vit_for_small_dataset import SPT

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    spt32 = SPT(dim, patch, device=dev, generator=g)
    with torch.no_grad():
        spt32.norm.weight.add_(torch.randn(spt32.norm.weight.shape, generator=g, device=dev) * 0.1)
        spt32.norm.bias.normal_(0.0, 0.1, generator=g)
    spt = cast_params(SPT(dim, patch, device=dev), torch.bfloat16)
    spt.load_state_dict(spt32.state_dict())
    # Pixels with a non-zero mean, where the convolution form subtracts nearly
    # equal terms.
    img = (torch.rand(batch, size, size, 3, generator=g, device=dev)).to(torch.bfloat16)
    def conv_tf32():
        torch.backends.cudnn.allow_tf32 = True
        try:
            return spt(img)
        finally:
            torch.backends.cudnn.allow_tf32 = False

    with torch.inference_mode():
        conv, eager, truth = spt(img), spt.plain(img), spt32.plain(img.float())
        err_c, err_e = ((t.float() - truth).abs().max().item() for t in (conv, eager))
        diff = (conv.float() - conv_tf32().float()).abs().max().item()
        ms = interleaved_medians(torch, {"conv": lambda: spt(img), "conv_tf32": conv_tf32,
                                         "eager": lambda: spt.plain(img)}, rounds=5, calls=10)
    log(f"spt [b={batch} {size}px patch {patch} dim {dim}, pixels in [0, 1)]: tokens "
        f"{tuple(conv.shape)}; against the f32 eager form max|conv-f32|={err_c:.6g} "
        f"max|eager bf16-f32|={err_e:.6g} (conv <= {MAX_ERR_VS_PLAIN_BF16}x eager); with cuDNN's "
        f"TF32 allowed max|diff|={diff:.6g}; ms convolution form={ms['conv']:.4f} "
        f"(TF32 allowed {ms['conv_tf32']:.4f}) eager form={ms['eager']:.4f} on {smi}")
    if not (bool(torch.isfinite(conv).all()) and err_c <= MAX_ERR_VS_PLAIN_BF16 * err_e):
        raise AssertionError(f"spt: convolution form {err_c} from f32, eager bf16 {err_e}")


PLAIN_KW = dict(fused_attention="never", fused_mlp="never")  # the ViTs' plain path

# (tag, b, heads, n_q, n_k, d): CvT-13's flash shapes at batch 64, the tier
# above n_k = 4096 (vit_tpu's flash_attention_v2) and ScalableViT's IWSA width.
FLASH_SHAPES = [
    ("CvT-13@224 stage 1", 64, 1, 3136, 784, 64),
    ("CvT-13@384 stage 1", 64, 1, 9216, 2304, 64),
    ("CvT-13@384 stage 2", 64, 3, 2304, 576, 64),
    ("n=8192, through the dispatcher", 4, 16, 8192, 8192, 64),
    ("n=4096, d=32", 64, 2, 4096, 4096, 32),
]
# CvT-13's attention shapes below the 1024 gate, where the plain path runs.
BELOW_GATE_SHAPES = [
    ("CvT-13@224 stage 2", 64, 3, 784, 196, 64),
    ("CvT-13@384 stage 3", 64, 6, 576, 144, 64),
    ("CvT-13@224 stage 3", 64, 6, 196, 49, 64),
]


def flash_inputs(torch, b, h, n_q, n_k, d, seed):
    """Seeded bf16 q, k, v and cotangent as CvT hands them over: q and the
    cotangent (b, h, n, d) views of channels-last (b, n, h·d) maps, k and v
    views of the two halves of one (b, n_k, 2·h·d) projection."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)

    def fold(t):
        return t.reshape(b, t.shape[1], h, d).permute(0, 2, 1, 3)

    k, v = (fold(t) for t in rn(b, n_k, 2 * h * d).chunk(2, dim=-1))
    return fold(rn(b, n_q, h * d)), k, v, fold(rn(b, n_q, h * d))


def flash_bounds(b, h, n_q, n_k, dk, dv=None):
    """Bounds of the two flash kernels: the FLOPs of the function, two
    n_q x n_k products forward (q·kᵀ at width dk, P·v at dv) and five
    backward (the q·kᵀ recompute, dq and dk at dk; dO·vᵀ and dv at dv: the
    second q·kᵀ and dO·vᵀ of the two-pass split are the kernels' own
    recomputation, not the gradient's work); q, k, v (and out, lse, dout)
    read once, out and lse (dq, dk, dv) written once, bf16 with f32 lse."""
    dv = dk if dv is None else dv
    pairs = b * h * n_q * n_k
    q, o = 2 * b * h * n_q * dk, 2 * b * h * n_q * dv
    k, v = 2 * b * h * n_k * dk, 2 * b * h * n_k * dv
    lse = 4 * b * h * n_q
    return {"flash_attention": bound(2 * pairs * (dk + dv), q + k + v + o + lse),
            "flash_backward": bound(2 * pairs * (3 * dk + 2 * dv),
                                    2 * (q + k + v + o) + lse)}


def sdpa_backward(torch, F, q, k, v, do, scale):
    """Autograd through PyTorch's scaled_dot_product_attention for dq, dk, dv."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    y = F.scaled_dot_product_attention(qg, kg, vg, scale=scale)
    return lambda: torch.autograd.grad(y, (qg, kg, vg), do, retain_graph=True)


def flash_phase(torch, results, smi):
    """The flash kernels at FLASH_SHAPES: out and lse against the plain
    version; dq, dk, dv against the plain backward fed the kernel's own out
    and lse, and twice bit for bit; times of the kernels, their plain
    versions and PyTorch's SDPA (autograd through it for the backward)."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops.attention import scaled_dot_product_attention

    for i, (tag, b, h, n_q, n_k, d) in enumerate(FLASH_SHAPES):
        q, k, v, do = flash_inputs(torch, b, h, n_q, n_k, d, seed=20 + i)
        scale = d ** -0.5
        shape = f"[{tag}: b={b} heads={h} n_q={n_q} n_k={n_k} d={d}]"
        before = fa.flash_attention.launches
        with torch.inference_mode():
            via = scaled_dot_product_attention(q, k, v, scale=scale) if n_k > 4096 else None
            out, lse = fa.flash_attention_forward(q, k, v, scale)
        torch.cuda.synchronize()
        if fa.flash_attention.launches != before + 1 + (via is not None):
            raise AssertionError(f"flash forward {shape}: launch counter did not move")
        if via is not None and not torch.equal(via, out):
            raise AssertionError(f"flash forward {shape}: the dispatcher's output differs")
        ref_out, ref_lse = fa.flash_attention_forward_reference(q, k, v, scale)
        err = check_outputs(torch, f"flash forward {shape}", (out,), (ref_out,), {})
        lse_err = (lse - ref_lse).abs().max().item()
        if not (lse.dtype == torch.float32 and lse_err <= LSE_ABS_TOL):
            raise AssertionError(f"flash forward {shape}: lse differs by {lse_err}")
        del ref_out, ref_lse
        before = fa.flash_backward.launches
        grads = fa.flash_backward(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        if fa.flash_backward.launches != before + 1:
            raise AssertionError(f"flash backward {shape}: launch counter did not move")
        bwd_err = check_outputs(torch, f"flash backward {shape}", grads,
                                fa.flash_backward_reference(q, k, v, out, lse, do, scale), {})
        again = fa.flash_backward(q, k, v, out, lse, do, scale)
        if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
            raise AssertionError(f"flash backward {shape}: two runs differ")
        del grads, again
        bounds = flash_bounds(b, h, n_q, n_k, d)
        fwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fa.flash_attention_forward(q, k, v, scale),
            "plain": lambda: fa.flash_attention_forward_reference(q, k, v, scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)},
            rounds=3, calls=3)
        bwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fa.flash_backward(q, k, v, out, lse, do, scale),
            "plain": lambda: fa.flash_backward_reference(q, k, v, out, lse, do, scale),
            "library": sdpa_backward(torch, F, q, k, v, do, scale)}, rounds=3, calls=3)
        fb, bb = bounds["flash_attention"], bounds["flash_backward"]
        log(f"flash {shape}: out within one bf16 unit plus {KERNEL_REL_TOL}*max|ref| of the "
            f"plain version, max|kernel-plain|={err:.6g}; lse max|diff|={lse_err:.3g} (<= "
            f"{LSE_ABS_TOL}); dq, dk, dv (fed the kernel's out and lse) max|diff|={bwd_err:.6g}, "
            f"the same bits in two runs"
            + ("; the dispatcher launched it, the same bits" if via is not None else "")
            + f"; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} "
            f"SDPA={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); backward ms kernel="
            f"{bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} autograd through SDPA="
            f"{bwd_ms['library']:.4f} bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault("flash_attention", {})[tag] = dict(
            err=err, lse_err=lse_err, **fwd_ms, bound=fb)
        results.setdefault("flash_backward", {})[tag] = dict(err=bwd_err, **bwd_ms, bound=bb)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


def below_gate_phase(torch, results, smi):
    """Below the 1024 gate, at BELOW_GATE_SHAPES, where ``"auto"`` runs the
    plain path: the flash kernels against the dispatcher's plain path
    (``plain_attention``; autograd through it for the backward) and SDPA, for
    the crossover a later change of the gate would rest on."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops.attention import plain_attention

    for i, (tag, b, h, n_q, n_k, d) in enumerate(BELOW_GATE_SHAPES):
        q, k, v, do = flash_inputs(torch, b, h, n_q, n_k, d, seed=40 + i)
        scale = d ** -0.5
        out, lse = fa.flash_attention_forward(q, k, v, scale)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        y = plain_attention(qg, kg, vg, scale=scale)
        fwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fa.flash_attention_forward(q, k, v, scale),
            "plain": lambda: plain_attention(q, k, v, scale=scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)},
            rounds=5, calls=10)
        bwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fa.flash_backward(q, k, v, out, lse, do, scale),
            "plain": lambda: torch.autograd.grad(y, (qg, kg, vg), do, retain_graph=True),
            "library": sdpa_backward(torch, F, q, k, v, do, scale)}, rounds=5, calls=10)
        log(f"below the gate [{tag}: b={b} heads={h} n_q={n_q} n_k={n_k} d={d}]: forward ms "
            f"flash kernel={fwd_ms['kernel']:.4f} plain path={fwd_ms['plain']:.4f} "
            f"SDPA={fwd_ms['library']:.4f}; backward ms flash kernel={bwd_ms['kernel']:.4f} "
            f"autograd through the plain path={bwd_ms['plain']:.4f} autograd through SDPA="
            f"{bwd_ms['library']:.4f} on {smi}")
        results.setdefault("below_gate", {})[tag] = {"forward": fwd_ms, "backward": bwd_ms}


# ScalableViT as benchmarks/run_benchmarks.py:140-144 builds it, at 256 px.
SCALABLE = dict(num_classes=1000, dim=64, heads=(2, 4, 8, 16), depth=(2, 2, 8, 2),
                ssa_dim_key=(40, 40, 40, 32), reduction_factor=(8, 4, 2, 1),
                window_size=(64, 32, None, None))
SCALABLE_SIZE = 256
# (tag, b, n, c, heads, n_k, dh_k, dh_v): its SSA blocks at batch 64.
SSA_SHAPES = [
    ("ScalableViT stage 1", 64, 4096, 64, 2, 64, 40, 32),
    ("ScalableViT stage 2", 64, 1024, 128, 4, 64, 40, 32),
    ("ScalableViT stage 3", 64, 256, 256, 8, 64, 40, 32),
    ("ScalableViT stage 4", 64, 64, 512, 16, 64, 32, 32),
]
# The cross-attention phase's shapes: the SSA_SHAPES, then ScalableViT at 384
# px, stage 1 (96² queries, 12² = 144 keys: past cross_fwd's 128, so the
# three-launch forward), batch 16.
CROSS_SHAPES = SSA_SHAPES + [("ScalableViT@384 stage 1", 16, 9216, 64, 2, 144, 40, 32)]
# (tag, b, n, heads, dk, dv): the packed flash op at its IWSA windows (stages
# 1 and 2, batch 64), and with q/k wider than v.
PACKED_SHAPES = [
    ("ScalableViT IWSA stage 1", 64, 4096, 2, 32, 32),
    ("ScalableViT IWSA stage 2", 64, 1024, 4, 32, 32),
    ("dk 40, dv 32", 64, 1024, 2, 40, 32),
]


def cross_bounds(b, n, c, heads, n_k, dh_k, dh_v):
    """Bounds of the cross-attention block: the q and output GEMMs and the
    flash FLOPs (:func:`flash_bounds`), forward; the doattn and dxn GEMMs and
    the flash backward's, backward.  Bytes: forward x, xn, Wq, k, v, Wo, bo in
    and y out; backward dy, q, k, v, oattn, lse, Wq, Wo in and dxn, dq, dk,
    dv, f32 dbo out (bf16 tensors, f32 lse)."""
    rows, hk, hv = b * n, heads * dh_k, heads * dh_v
    pairs = b * heads * n * n_k
    act, w = 2 * rows * c, 2 * c * (hk + hv)
    kv = 2 * b * n_k * (hk + hv)
    gemms = 2 * rows * c * (hk + hv)
    return {
        "fused_cross_attention": bound(gemms + 2 * pairs * (dh_k + dh_v),
                                       3 * act + kv + w + 2 * c),
        "fused_cross_attention_bwd": bound(
            gemms + 2 * pairs * (3 * dh_k + 2 * dh_v),
            2 * act + 2 * kv + 2 * rows * (2 * hk + hv) + 4 * b * heads * n + w + 4 * c),
    }


def cross_attention_phase(torch, results, smi):
    """The fused cross-attention block at CROSS_SHAPES, bf16 inputs from a
    seeded generator: the serving forward on the route the library gives
    the shape (one cross_fwd launch keeping no residual below 256 channels,
    cross_fwd and the y GEMM keeping oattn from 256, the three launches
    keeping q, oattn and lse past 128 keys) and the training
    forward (y, q, oattn; lse against the plain attention on the kernel's q)
    against the plain version, each twice bit for bit; the backward, fed the
    training forward's residuals, against the plain backward on them (dxn,
    dq, dk, dv within one unit plus 2e-2·max|ref|, dbo within
    DBIAS_REL_TOL·max|ref|), twice bit for bit.  Times of the kernels, the
    plain versions and the library composition (F.linear +
    scaled_dot_product_attention + F.linear in bf16, autograd through it for
    the backward), and the bounds."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.ops import flash_attention_packed as fap
    from vit_tpu_torch.ops import fused_cross_attention as fca
    from vit_tpu_torch.ops._shared import weight_grad

    for i, (tag, b, n, c, heads, n_k, dh_k, dh_v) in enumerate(CROSS_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(50 + i)

        def rn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

        hk, hv = heads * dh_k, heads * dh_v
        args = (rn(b, n, c), rn(b, n, c), rn(hk, c, scale=c ** -0.5), rn(b, n_k, hk),
                rn(b, n_k, hv), rn(c, hv, scale=hv ** -0.5), rn(c, scale=0.1))
        x, xn, wq, k, v, wo, bo = args
        dy = rn(b, n, c, scale=0.1)
        cfg = (heads, dh_k, dh_v)
        scale = dh_k ** -0.5
        shape = f"[{tag}: b={b} n={n} c={c} heads={heads} n_k={n_k} dh_k={dh_k} dh_v={dh_v}]"
        # The forward's route (csrc/fused_cross_attention.cu cross_mode): 1,
        # the one cross_fwd kernel (stages 1-2); 2, cross_fwd then the y GEMM
        # (c >= 256: stages 3-4); 0, the three launches (n_k > 128: 384 px).
        route = _build.load().vit_fused_cross_attention_fused(b, n, n_k, c, heads, dh_k, dh_v)
        expected = 0 if n_k > 128 else 1 if c < 256 else 2
        # The backward's (cross_bwd_plan): 1, one cross_bwd kernel and its
        # reduction (c <= 128: stages 1-2); 2, cross_bwd between gemm_wgmma's
        # two dgrads (stages 3-4); 0, the four steps (n_k > 128: 384 px).
        bwd_route = fca.backward_route(b, n, n_k, c, heads, dh_k, dh_v)
        if bwd_route != (0 if n_k > 128 else 1 if c <= 128 else 2):
            raise AssertionError(f"cross-attention backward {shape}: route {bwd_route}")
        with torch.inference_mode():
            before = fca.fused_cross_attention.launches
            out = fca.fused_cross_attention(*args, *cfg)
            torch.cuda.synchronize()
            if fca.fused_cross_attention.launches != before + 1:
                raise AssertionError(f"cross-attention {shape}: launch counter did not move")
            err, excess, tol = block_error(torch, out, fca.fused_cross_attention_reference(
                *args, *cfg), x)
            if not torch.equal(out, fca.fused_cross_attention(*args, *cfg)):
                raise AssertionError(f"cross-attention {shape}: two serving runs differ")
            kept = [t is not None for t in fca._launch_forward(*args, *cfg, scale)[1:]]
        if not (bool(torch.isfinite(out).all()) and excess <= tol):
            raise AssertionError(f"cross-attention {shape}: differs from its plain version by "
                                 f"{excess} beyond one output unit > {tol}")
        if route != expected or kept != [route == 0, route != 1, route == 0]:
            raise AssertionError(f"cross-attention {shape}: route {route}, serving kept "
                                 f"(q, oattn, lse) {kept}")
        train = fca._launch_forward(*args, *cfg, scale, training=True)
        ref = fca.fused_cross_attention_forward_reference(*args, *cfg)
        train_err = check_outputs(torch, f"cross-attention training forward {shape}", train[:3],
                                  ref[:3], {0: x})
        if not all(torch.equal(a, b_) for a, b_ in
                   zip(train, fca._launch_forward(*args, *cfg, scale, training=True))):
            raise AssertionError(f"cross-attention training forward {shape}: two runs differ")
        _, q, oattn, lse = train
        # lse against the plain attention on the kernel's own q: a one-unit
        # flip of a q element between the two q GEMMs moves a logit, and so
        # lse, by up to a unit of q times |k|·scale (5e-3 here).
        lse_err = (lse - fap.flash_attention_packed_forward_reference(q, k, v, heads, scale)[1]
                   ).abs().max().item()
        if not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"cross-attention training forward {shape}: lse differs by "
                                 f"{lse_err}")
        del ref

        def kernel(route=None):
            return fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, *cfg,
                                                      route=route)

        def whole():
            out = kernel()
            return out, weight_grad(out[1], xn), weight_grad(dy, oattn)

        def plain(route=bwd_route):  # the four steps take D from the stored output
            return fca.fused_cross_attention_backward_reference(
                dy, q, k, v, oattn, lse, wq, wo, *cfg, stored_output_d=route == 0)

        before = fca.fused_cross_attention_backward.launches
        on_route = fca.BACKWARD_ROUTES[bwd_route].launches
        got = kernel()
        torch.cuda.synchronize()
        if fca.fused_cross_attention_backward.launches != before + 1 or \
                fca.BACKWARD_ROUTES[bwd_route].launches != on_route + 1:
            raise AssertionError(f"cross-attention backward {shape}: launch counter did not move")
        want = plain()
        bwd_err = check_outputs(torch, f"cross-attention backward {shape}", got[:4], want[:4], {})
        dbo_err = check_dbias(torch, f"cross-attention backward {shape}", got[4], want[4], "dbo")
        if not all(torch.equal(a, b_) for a, b_ in zip(got, kernel())):
            raise AssertionError(f"cross-attention backward {shape}: two runs differ")
        del got, want
        # The other designs at this shape, each held against its plain version:
        # the four steps (the earlier design, route 0) wherever cross_bwd runs,
        # and cross_bwd split from its dgrads (route 2) where it takes them.
        designs = {name: r for name, r in (("four steps", 0), ("split", 2))
                   if bwd_route != 0 and r != bwd_route}
        for name, r in designs.items():
            got, want = kernel(r), plain(r)
            check_outputs(torch, f"cross-attention backward {shape}, {name}", got[:4], want[:4],
                          {})
            check_dbias(torch, f"cross-attention backward {shape}, {name}", got[4], want[4],
                        "dbo")
            del got, want
        if bwd_route != 0:  # where the device time goes, launch by launch, on both designs
            for name, r in ((f"route {bwd_route}", None), ("four steps", 0)):
                rows = launch_breakdown(torch, lambda: kernel(r))
                log(f"cross-attention backward {shape}, {name}: "
                    f"{sum(cnt for _, cnt in rows.values()):g} launches, device ms "
                    f"{sum(ms for ms, _ in rows.values()):.4f}: "
                    + "; ".join(f"{g} x{cnt:g} {ms:.4f}" for g, (ms, cnt) in rows.items())
                    + f" on {smi}")

        def library(xn_, wq_, k_, v_, wo_, bo_):
            o = F.scaled_dot_product_attention(fap.split_heads(F.linear(xn_, wq_), heads),
                                               fap.split_heads(k_, heads),
                                               fap.split_heads(v_, heads), scale=scale)
            return x + F.linear(fap.merge_heads(o), wo_, bo_)

        leaves = [t.detach().requires_grad_() for t in (xn, wq, k, v, wo, bo)]
        y_lib = library(*leaves)
        own = [leaves[0], leaves[2], leaves[3], leaves[5]]  # the kernel's own outputs' inputs
        with torch.inference_mode():
            fwd_ms = interleaved_medians(torch, {
                "kernel": lambda: fca.fused_cross_attention(*args, *cfg),
                "plain": lambda: fca.fused_cross_attention_reference(*args, *cfg),
                "library": lambda: library(xn, wq, k, v, wo, bo)}, rounds=5, calls=5)
        bwd_ms = interleaved_medians(torch, {
            "kernel": kernel, "plain": plain, "whole": whole,
            **{name: (lambda r=r: kernel(r)) for name, r in designs.items()},
            "library": lambda: torch.autograd.grad(y_lib, own, dy, retain_graph=True),
            "library_whole": lambda: torch.autograd.grad(y_lib, leaves, dy, retain_graph=True)},
            rounds=5, calls=5)
        bounds = cross_bounds(b, n, c, heads, n_k, dh_k, dh_v)
        fb, bb = bounds["fused_cross_attention"], bounds["fused_cross_attention_bwd"]
        log(f"cross-attention {shape}: forward "
            + ("one cross_fwd launch, serving keeps no residual" if route == 1 else
               "cross_fwd, then gemm_wgmma for y from oattn, serving keeps oattn only"
               if route == 2 else "three launches (linear.cu q GEMM, the (dh_k, dh_v) flash "
               "forward, linear.cu output GEMM), serving keeps q, oattn and lse")
            + f"; serving y within one bf16 unit plus 2e-2*max|ref-x|, "
            f"max|kernel-plain|={err:.6g}; training forward (y, q, oattn) max {train_err:.6g}, "
            f"lse {lse_err:.3g}; backward "
            + ("one cross_bwd kernel and its reduction" if bwd_route == 1 else
               "gemm_wgmma dy·Wo, cross_bwd over head groups, gemm_wgmma dq·Wq, column sums, "
               "the reduction" if bwd_route == 2 else "four steps (linear.cu dy·Wo, the "
               "(dh_k, dh_v) flash backward, linear.cu dq·Wq, column sums)")
            + f" (dxn, dq, dk, dv) fed the forward's residuals max "
            f"{bwd_err:.6g}, dbo {dbo_err:.3g} (<= {DBIAS_REL_TOL}*max|ref|), the same bits in "
            f"two runs; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} "
            f"F.linear+SDPA+F.linear={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); "
            f"backward ms kernel={bwd_ms['kernel']:.4f} "
            + "".join(f"{name}={bwd_ms[name]:.4f} " for name in designs)
            + f"plain={bwd_ms['plain']:.4f} autograd "
            f"through the library composition={bwd_ms['library']:.4f}; with dWq, dWo: "
            f"kernel+dW GEMMs={bwd_ms['whole']:.4f} autograd={bwd_ms['library_whole']:.4f}; "
            f"bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault("fused_cross_attention", {})[tag] = dict(
            err=max(err, train_err), lse_err=lse_err, route=route, **fwd_ms, bound=fb)
        results.setdefault("fused_cross_attention_bwd", {})[tag] = dict(
            err=bwd_err, dbo_err=dbo_err, route=bwd_route, **bwd_ms, bound=bb)
        del args, x, xn, wq, k, v, wo, bo, dy, train, q, oattn, lse, leaves, own, y_lib
        torch.cuda.empty_cache()


def packed_phase(torch, results, smi):
    """The channel-packed flash op at PACKED_SHAPES, seeded bf16 (b, n,
    heads·d) inputs: out and lse against the plain version; dq, dk, dv (the
    flash backward on the packed strides, as the op's autograd runs it) fed
    the kernel's own out and lse against the plain backward, twice bit for
    bit; times of the kernels, their plain versions and SDPA on the head
    views (autograd through it for the backward), and the bounds."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops import flash_attention_packed as fap

    for i, (tag, b, n, heads, dk, dv) in enumerate(PACKED_SHAPES):
        g = torch.Generator(device="cuda").manual_seed(60 + i)
        q, k, v, do = (torch.randn(b, n, heads * d, generator=g, device="cuda")
                       .to(torch.bfloat16) for d in (dk, dk, dv, dv))
        scale = dk ** -0.5
        shape = f"[{tag}: b={b} n={n} heads={heads} dk={dk} dv={dv}, channel-packed]"

        def heads_of(*ts):
            return [fap.split_heads(t, heads) for t in ts]

        before = fap.flash_attention_packed.launches
        with torch.inference_mode():
            out, lse = fap.flash_attention_packed_forward(q, k, v, heads, scale)
        torch.cuda.synchronize()
        if fap.flash_attention_packed.launches != before + 1:
            raise AssertionError(f"packed flash {shape}: launch counter did not move")
        ref_out, ref_lse = fap.flash_attention_packed_forward_reference(q, k, v, heads, scale)
        err = check_outputs(torch, f"packed flash forward {shape}", (out,), (ref_out,), {})
        lse_err = (lse - ref_lse).abs().max().item()
        if not (lse.dtype == torch.float32 and lse_err <= LSE_ABS_TOL):
            raise AssertionError(f"packed flash forward {shape}: lse differs by {lse_err}")
        del ref_out, ref_lse

        def kernel():
            return [fap.merge_heads(t) for t in fa.flash_backward(
                *heads_of(q, k, v, out), lse, fap.split_heads(do, heads), scale)]

        def plain():
            return fap.flash_attention_packed_backward_reference(q, k, v, out, lse, do, heads,
                                                                 scale)

        before = fa.flash_backward.launches
        grads = kernel()
        torch.cuda.synchronize()
        if fa.flash_backward.launches != before + 1:
            raise AssertionError(f"packed flash backward {shape}: launch counter did not move")
        bwd_err = check_outputs(torch, f"packed flash backward {shape}", grads, plain(), {})
        if not all(torch.equal(a, b_) for a, b_ in zip(grads, kernel())):
            raise AssertionError(f"packed flash backward {shape}: two runs differ")
        del grads
        fwd_ms = interleaved_medians(torch, {
            "kernel": lambda: fap.flash_attention_packed_forward(q, k, v, heads, scale),
            "plain": lambda: fap.flash_attention_packed_forward_reference(q, k, v, heads, scale),
            "library": lambda: F.scaled_dot_product_attention(*heads_of(q, k, v), scale=scale)},
            rounds=3, calls=3)
        bwd_ms = interleaved_medians(torch, {
            "kernel": kernel, "plain": plain,
            "library": sdpa_backward(torch, F, *heads_of(q, k, v, do), scale)},
            rounds=3, calls=3)
        bounds = flash_bounds(b, heads, n, n, dk, dv)
        fb, bb = bounds["flash_attention"], bounds["flash_backward"]
        log(f"packed flash {shape}: out within one bf16 unit plus {KERNEL_REL_TOL}*max|ref| of "
            f"the plain version, max|kernel-plain|={err:.6g}; lse max|diff|={lse_err:.3g}; dq, "
            f"dk, dv (fed the kernel's out and lse) max|diff|={bwd_err:.6g}, the same bits in two "
            f"runs; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} SDPA on "
            f"the head views={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); backward ms "
            f"kernel={bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} autograd through SDPA="
            f"{bwd_ms['library']:.4f} bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault("flash_attention_packed", {})[tag] = dict(
            err=err, lse_err=lse_err, **fwd_ms, bound=fb)
        results.setdefault("flash_backward (packed)", {})[tag] = dict(
            err=bwd_err, **bwd_ms, bound=bb)
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()


# (tag, b, h, n_q, n_k, d): the short-attention op at ViT-B/16's attention
# (vit_tpu's own v5e measurement of the op, short_attention.py:15-17), CvT-13
# @224's stage 3 below the flash gate, the MAX_SEQ edge at d 64 and 128, and a
# ragged cross-attention.
SHORT_SHAPES = [
    ("ViT-B/16 attention", 64, 12, 197, 197, 64),
    ("CvT-13@224 stage 3", 64, 6, 196, 49, 64),
    ("n=512, d=64", 16, 8, 512, 512, 64),
    ("n=512, d=128", 16, 8, 512, 512, 128),
    ("cross-attention, ragged", 2, 2, 65, 130, 32),
]


# The kernels rebuilt for Hopper (csrc/hopper.cuh: TMA rings on mbarriers,
# wgmma), and the times of the designs they replaced (mma.sync with
# synchronous staging; for proj_mlp, the block forwards' GEMMs and the block
# backwards' dgrads, linear.cu's cp.async GEMM, and for the unbiased block's
# attention mha_fwd's online softmax and mha_bwd's FA2 split; for ln_gemm, the
# earlier one-tile-a-CTA wgmma GEMM), ms on an H100 80GB HBM3 at 700 W:
# constants cited from PERF.md's kernel table and its findings on the
# rebuilds, printed on a line of their own beside the kernels' line, never in
# it (every number there is this run's).  The flash forward's rebuild also
# runs the packed op's forward; the short backward's runs attention_nb's.  The
# biased block's and the cross-attention block's forward's are the parent
# design's (mha_fwd / mha_bwd; q GEMM + flash forward + output GEMM); the
# cross-attention block's backward's the four steps (linear.cu's dy·Wo, the
# flash backward, linear.cu's dq·Wq, column sums).  Rows 2, 4, 5 (backward),
# 12 and 14's backwards: the design before the LayerNorm-backward epilogue
# (PERF.md's table), the dgrad into the LayerNorm backward writing an f32 dxn
# that layernorm.cu's passes read back, row 12's dgrad on linear.cu.
DESIGNS = {"flash_attention": "wgmma+tma", "flash_backward": "wgmma+tma",
           "fused_cross_attention": "one cross_fwd kernel (wgmma+tma): per head q = xn·Wq_h, "
                                    "softmax and P·V in registers, then y = oattn·Wo over the "
                                    "heads with bias and residual; no residual when serving",
           "flash_attention_packed": "wgmma+tma",
           "short_attention": "wgmma+tma", "ln_gemm": "wgmma+tma, warp-specialised, persistent",
           "attention_nb": "wgmma+tma", "proj_mlp": "wgmma+tma, warp-specialised, persistent",
           "short_attention_bwd": "tma ring, key block sized to n; mma.sync, wgmma at 129-256 keys",
           "attention_nb_bwd": "tma ring, key block sized to n; mma.sync, wgmma at 129-256 keys",
           "fused_mlp_bwd": "dgrads on gemm_wgmma (wgmma+tma, warp-specialised, persistent, B "
                            "MN-major) from n 256, linear.cu below: dy·W2 with the dGELU "
                            "epilogue, dh·W1 with the LayerNorm backward as its epilogue on a "
                            "thread-block cluster (dxn on chip, row partials through DSMEM) "
                            "at d % 256 == 0 in 256..2048",
           "fused_attention_block_bwd": "dgrads on gemm_wgmma with B MN-major, dqkv·Wqkv with "
                                        "the LayerNorm backward as its epilogue on a cluster "
                                        "(dxn on chip); attention on short_bwd up to 512 "
                                        "tokens, mha_bwd past them",
           "fused_attention_block_bias_bwd": "dgrads on gemm_wgmma with B MN-major, dqkv·Wqkv "
                                             "with the LayerNorm backward as its epilogue on a "
                                             "cluster; attention on short_bwd with the bias "
                                             "(two 144-key blocks at n 257) up to 512 tokens, "
                                             "dbias from its (lse, D) in a fixed order; mha_bwd "
                                             "past them",
           "ln_gemm_bwd": "dqkv·W on gemm_wgmma (B MN-major) with the LayerNorm backward, no "
                          "residual, as its epilogue on a thread-block cluster: dxn on chip, "
                          "row partials through DSMEM, fixed-order column sums",
           "fused_mlp": "fc1 and fc2 on gemm_wgmma (wgmma+tma, warp-specialised, persistent, "
                        "fused epilogues) from n 256, linear.cu below",
           "fused_attention_block": "QKV and out-projection on gemm_wgmma from n 256; attention "
                                    "on short_fwd (wgmma+tma, keeps lse in training) up to 512 "
                                    "tokens, mha_fwd past them",
           "fused_attention_block_bias": "QKV and out-projection on gemm_wgmma from n 256; "
                                         "attention on short_fwd with the bias (two 144-key "
                                         "tiles at n 257, keeps lse in training) up to 512 "
                                         "tokens, mha_fwd past them",
           "fused_cross_attention_bwd": "one cross_bwd kernel (wgmma+tma) up to c 128: per "
                                        "head doattn = dy·Wo_h, p from lse, dsum = Σ p·dp, ds "
                                        "and dq on chip, dk/dv over a span of query blocks in "
                                        "registers, then dxn = dq·Wq; f32 partials summed in "
                                        "a fixed order; from c 129 cross_bwd over head groups "
                                        "between gemm_wgmma's dgrads; four steps past 128 keys",
           "proj_mlp_bwd": "three dgrads on gemm_wgmma (wgmma+tma, warp-specialised, "
                           "persistent, B MN-major): dGELU, the LayerNorm backward on a "
                           "cluster (dxn on chip), store"}
EARLIER_DESIGN_MS = {
    "flash_attention": {"CvT-13@224 stage 1": 0.3540, "CvT-13@384 stage 1": 2.2336,
                        "CvT-13@384 stage 2": 0.5668, "n=8192, through the dispatcher": 6.7406},
    "flash_attention_packed": {"ScalableViT IWSA stage 1": 2.4982},
    "fused_cross_attention": {"ScalableViT stage 1": 0.2648},
    "fused_cross_attention_bwd": {"ScalableViT stage 1": 0.6243, "ScalableViT stage 2": 0.2868,
                                  "ScalableViT stage 3": 0.1601, "ScalableViT stage 4": 0.1118},
    "ln_gemm": {"B/32": 0.1517},
    "proj_mlp": {"B/32": 0.4404},
    "proj_mlp_bwd": {"B/32": 0.3592},
    "ln_gemm_bwd": {"B/32": 0.2490},
    "flash_backward": {"CvT-13@224 stage 1": 1.3212, "CvT-13@384 stage 1": 8.2769,
                       "CvT-13@384 stage 2": 1.8241, "n=8192, through the dispatcher": 24.0999,
                       "n=4096, d=32": 9.6678},
    "flash_backward (packed)": {"ScalableViT IWSA stage 1": 9.7670,
                                "ScalableViT IWSA stage 2": 1.5143, "dk 40, dv 32": 0.9418},
    "short_attention": {"ViT-B/16 attention": 0.3046, "CvT-13@224 stage 3": 0.0819,
                        "n=512, d=64": 0.2990, "n=512, d=128": 0.4042,
                        "cross-attention, ragged": 0.0673},
    "attention_nb": {"B/32": 0.1732},
    "short_attention_bwd": {"ViT-B/16 attention": 0.6722, "CvT-13@224 stage 3": 0.1721,
                            "n=512, d=64": 0.4995, "n=512, d=128": 0.7270,
                            "cross-attention, ragged": 0.1301},
    "attention_nb_bwd": {"B/32": 0.4285},
    "fused_mlp_bwd": {"B/16": 0.5082, "B/32": 0.3059},
    "fused_attention_block_bwd": {"B/16": 0.4540, "B/32": 0.3488},
    "fused_attention_block_bias_bwd": {"lsa": 1.0548, "shared": 1.9904, "per-head": 1.7430},
    "fused_mlp": {"B/16": 0.5743, "B/32": 0.3257},
    "fused_attention_block": {"B/16": 0.4872, "B/32": 0.4362},
    "fused_attention_block_bias": {"lsa": 0.6170, "shared": 0.6236, "per-head": 0.6210},
}


def short_bounds(b, h, n_q, n_k, d):
    """Bounds of the short-attention kernels (and of attention_nb, the same
    kernels over the (n, b, heads·dh) layout): the FLOPs of the function,
    two n_q x n_k products forward (q·kᵀ, p·v) and five backward (q·kᵀ, dO·vᵀ,
    dv, dq, dk); bytes: forward q, k, v read and out written (the serving
    forward, no lse), backward q, k, v, dout read and dq, dk, dv written, the
    inputs the TPU kernel's backward takes (the port's also reads the stored
    out and lse, for D and the softmax statistics), bf16."""
    pairs = b * h * n_q * n_k
    q, k = 2 * b * h * n_q * d, 2 * b * h * n_k * d
    return {"short_attention": bound(4 * pairs * d, 2 * q + 2 * k),
            "short_attention_bwd": bound(10 * pairs * d, 3 * q + 4 * k)}


def hybrid_bounds(b, n, d, heads, dim_head, hidden):
    """Bounds of the hybrid layer's kernels at one shape (t = b·n rows, bf16
    activations and weights, f32 parameter-gradient sums): the FLOPs of the
    TPU kernels' own GEMMs and attention products; each input read once and
    each output written once.  ln_gemm: x, γ, β, Wqkv -> q|k|v (serving, no
    xn); backward dqkv, x, γ, Wqkv -> dx, f32 dγ, dβ, over the dxn GEMM.
    attention_nb: :func:`short_bounds`.  proj_mlp: x, o, Wo, bo, γ, β, W1,
    b1, W2, b2 -> z over three GEMMs; backward dz, y, h, γ, Wo, W1, W2 -> dy,
    do, dh, gact and f32 dγ, dβ, dbo, db1, db2 over three dgrad GEMMs."""
    t, inner = b * n, heads * dim_head
    act, qkv, o, h = 2 * t * d, 2 * t * 3 * inner, 2 * t * inner, 2 * t * hidden
    w_qkv = 2 * 3 * inner * d
    w_mlp = 2 * (inner * d + 2 * d * hidden)  # Wo, W1, W2
    mlp_flops = 2 * t * (inner * d + 2 * d * hidden)
    short = short_bounds(b, heads, n, n, dim_head)
    return {
        "ln_gemm": bound(2 * t * d * 3 * inner, act + w_qkv + 4 * d + qkv),
        "ln_gemm_bwd": bound(2 * t * 3 * inner * d, qkv + act + 2 * d + w_qkv + act + 8 * d),
        "attention_nb": short["short_attention"],
        "attention_nb_bwd": short["short_attention_bwd"],
        "proj_mlp": bound(mlp_flops, act + o + w_mlp + 2 * (4 * d + hidden) + act),
        "proj_mlp_bwd": bound(mlp_flops, 2 * act + h + 2 * d + w_mlp + act + o + 2 * h
                              + 4 * (4 * d + hidden)),
    }


def short_attention_phase(torch, results, smi, counters):
    """The short-attention op at SHORT_SHAPES, seeded bf16 (b, h, n, d)
    inputs.  First its path: every counter from 0, the public op under
    autograd, forward and backward, once, at the first shape; the counters
    read right after are the phase's launches.  Then at each shape: out and
    lse against the plain version; dq, dk, dv fed the kernel's own out and
    lse against the plain backward, twice bit for bit; times of the kernels,
    their plain versions, PyTorch's SDPA (autograd through it for the
    backward) and the port's flash kernels on the same inputs, and the
    bounds."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import flash_attention as fa
    from vit_tpu_torch.ops import short_attention as sa

    def inputs(b, h, n_q, n_k, d, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return [torch.randn(b, h, n, d, generator=g, device="cuda").to(torch.bfloat16)
                for n in (n_q, n_k, n_k, n_q)]

    q, k, v, do = inputs(*SHORT_SHAPES[0][1:], seed=70)
    for c in counters.values():
        c.launches = 0
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sa.short_attention(*leaves).backward(do)
    torch.cuda.synchronize()
    launches = {name: c.launches for name, c in counters.items()}
    check_launches("short attention", "one forward and backward", counters,
                   {"short_attention": 1, "short_attention_bwd": 1}, 1)
    del leaves

    for i, (tag, b, h, n_q, n_k, d) in enumerate(SHORT_SHAPES):
        q, k, v, do = inputs(b, h, n_q, n_k, d, seed=70 + i)
        scale = d ** -0.5
        shape = f"[{tag}: b={b} heads={h} n_q={n_q} n_k={n_k} d={d}]"
        out, lse = sa.short_attention_forward(q, k, v, scale)
        ref_out, ref_lse = sa.short_attention_forward_reference(q, k, v, scale)
        err = check_outputs(torch, f"short attention forward {shape}", (out,), (ref_out,), {})
        lse_err = (lse - ref_lse).abs().max().item()
        if not lse_err <= LSE_ABS_TOL:
            raise AssertionError(f"short attention forward {shape}: lse differs by {lse_err}")
        del ref_out, ref_lse
        grads = sa.short_attention_backward(q, k, v, out, lse, do, scale)
        torch.cuda.synchronize()
        bwd_err = check_outputs(torch, f"short attention backward {shape}", grads,
                                sa.short_attention_backward_reference(q, k, v, out, lse, do,
                                                                      scale), {})
        again = sa.short_attention_backward(q, k, v, out, lse, do, scale)
        if not all(torch.equal(a, b_) for a, b_ in zip(grads, again)):
            raise AssertionError(f"short attention backward {shape}: two runs differ")
        del grads, again
        f_out, f_lse = fa.flash_attention_forward(q, k, v, scale)
        fwd_ms = interleaved_medians(torch, {
            "kernel": lambda: sa.short_attention_forward(q, k, v, scale, need_lse=False),
            "plain": lambda: sa.short_attention_forward_reference(q, k, v, scale),
            "library": lambda: F.scaled_dot_product_attention(q, k, v, scale=scale),
            "flash": lambda: fa.flash_attention_forward(q, k, v, scale)}, rounds=3, calls=3)
        bwd_ms = interleaved_medians(torch, {
            "kernel": lambda: sa.short_attention_backward(q, k, v, out, lse, do, scale),
            "plain": lambda: sa.short_attention_backward_reference(q, k, v, out, lse, do, scale),
            "library": sdpa_backward(torch, F, q, k, v, do, scale),
            "flash": lambda: fa.flash_backward(q, k, v, f_out, f_lse, do, scale)},
            rounds=3, calls=3)
        bounds = short_bounds(b, h, n_q, n_k, d)
        fb, bb = bounds["short_attention"], bounds["short_attention_bwd"]
        log(f"short attention {shape}: out within one bf16 unit plus {KERNEL_REL_TOL}*max|ref| "
            f"of the plain version, max|kernel-plain|={err:.6g}; lse max|diff|={lse_err:.3g}; dq, "
            f"dk, dv (fed the kernel's out and lse) max|diff|={bwd_err:.6g}, the same bits in two "
            f"runs; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} "
            f"SDPA={fwd_ms['library']:.4f} flash kernel={fwd_ms['flash']:.4f} bound={fb[0]:.4f} "
            f"({fb[1]}); backward ms kernel={bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} "
            f"autograd through SDPA={bwd_ms['library']:.4f} flash kernels={bwd_ms['flash']:.4f} "
            f"bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault("short_attention", {})[tag] = dict(
            err=err, lse_err=lse_err, **fwd_ms, bound=fb)
        results.setdefault("short_attention_bwd", {})[tag] = dict(err=bwd_err, **bwd_ms, bound=bb)
        del q, k, v, do, out, lse, f_out, f_lse
        torch.cuda.empty_cache()
    return launches


def hybrid_phase(torch, tag, b, n, d, heads, dim_head, hidden, results, smi):
    """The hybrid layer's kernels at one layer shape, seeded bf16 inputs in
    the (n, b, ·) row order of the tier: ln_gemm's training forward (q|k|v,
    xn), attention_nb's (o, lse; on the kernel's q, k, v, column views of
    its one output) and proj_mlp's (z, y, xn, h; on the kernel's o) against
    their plain versions; then each backward, fed the residuals its own
    forward kept (proj_mlp's from a seeded dz, attention_nb's from proj_mlp's
    do, ln_gemm's from attention_nb's one dq|dk|dv buffer), against its plain
    backward on them, and twice bit for bit.  Times of the serving forwards
    and of the backwards, their plain versions and the library: bf16
    ``F.layer_norm`` + ``F.linear`` (ln_gemm), SDPA on the head views
    (attention_nb) and the bf16 out-projection + LayerNorm + MLP (proj_mlp),
    autograd through them for the backwards (for the kernels' own outputs,
    and with the weight gradients beside the kernel plus its dW GEMMs)."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops import fused_hybrid as fh
    from vit_tpu_torch.ops import short_attention as sa
    from vit_tpu_torch.ops._shared import weight_grad

    dev, dt, eps = torch.device("cuda"), torch.bfloat16, 1e-3
    g = torch.Generator(device=dev).manual_seed(80)
    t, inner = b * n, heads * dim_head
    scale = dim_head ** -0.5

    def rn(*shape, scale=1.0, shift=0.0):
        return (shift + torch.randn(*shape, generator=g, device=dev) * scale).to(dt)

    x = rn(t, d)
    ln1 = (rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1))
    wqkv = rn(3 * inner, d, scale=d ** -0.5)
    wo, bo = rn(d, inner, scale=inner ** -0.5), rn(d, scale=0.1)
    ln2 = (rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1))
    mlp_w = (rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1),
             rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1))
    w1, _, w2, _ = mlp_w
    dz = rn(t, d, scale=0.1)
    shape = f"[{tag}: t={t} (n={n}, b={b}) d={d} heads={heads}x{dim_head} h={hidden}]"

    def nb(a):
        return a.reshape(n, b, a.shape[-1])

    # The training forwards, chained as the layer chains them.
    qkv, xn1 = fh._launch_ln_gemm(x, *ln1, wqkv, eps)
    errs = {"ln_gemm": check_outputs(torch, f"ln_gemm {shape}", (qkv, xn1),
                                     fh.ln_gemm_forward_reference(x, *ln1, wqkv, eps), {})}
    q, k, v = (nb(a) for a in qkv.chunk(3, -1))
    o, lse = fh.attention_nb_forward(q, k, v, heads, dim_head)
    ref_o, ref_lse = fh.attention_nb_forward_reference(q, k, v, heads, dim_head)
    errs["attention_nb"] = check_outputs(torch, f"attention_nb {shape}", (o,), (ref_o,), {})
    lse_err = (lse - ref_lse).abs().max().item()
    if not lse_err <= LSE_ABS_TOL:
        raise AssertionError(f"attention_nb {shape}: lse differs by {lse_err}")
    o2 = o.reshape(t, inner)
    z, y, xn2, h = fh._launch_proj_mlp(x, o2, wo, bo, *ln2, *mlp_w, eps, save_residuals=True)
    ref = fh.proj_mlp_forward_reference(x, o2, wo, bo, *ln2, *mlp_w, eps)
    errs["proj_mlp"] = check_outputs(torch, f"proj_mlp {shape}", (z, y, xn2, h), ref,
                                     {0: ref[1], 1: x})
    del ref, ref_o, ref_lse

    # The backwards, each fed its forward's residuals, twice.
    def twice(name, kernel, plain, residuals):
        got = kernel()
        torch.cuda.synchronize()
        errs[name + "_bwd"] = check_outputs(torch, f"{name} backward {shape}", got, plain(),
                                            residuals)
        if not all(torch.equal(a, b_) for a, b_ in zip(got, kernel())):
            raise AssertionError(f"{name} backward {shape}: two runs differ")
        return got

    def proj_bwd():
        return fh.proj_mlp_backward(dz, y, h, ln2[0], wo, w1, w2, eps)

    dy, do, dh, gact = twice("proj_mlp", proj_bwd, lambda: fh.proj_mlp_backward_reference(
        dz, y, h, ln2[0], wo, w1, w2, eps), {0: dz})[:4]
    do_nb = nb(do)
    # Its three dgrads run on gemm_wgmma (launch_dgrad, n >= 256 here): none on
    # linear.cu; dh·W1's epilogue is the LayerNorm backward.
    rows, device = {}, {}
    rows["proj_mlp"], device["proj_mlp"] = check_ln_epilogue(
        torch, f"proj_mlp backward {shape}", proj_bwd, banned=("linear_kernel",))
    log(f"hybrid proj_mlp backward {shape}: device ms launch by launch "
        + "; ".join(f"{g} x{cnt:g} {ms:.4f}" for g, (ms, cnt) in rows["proj_mlp"].items())
        + f" on {smi}")
    if sum(round(cnt) for g, (_, cnt) in rows["proj_mlp"].items()
           if g.startswith("gemm_wgmma")) != 3:
        raise AssertionError(f"proj_mlp backward {shape}: its dgrads are not gemm_wgmma's three")

    def attn_bwd():
        return fh.attention_nb_backward(do_nb, q, k, v, o, lse, heads, dim_head)

    attn_grads = twice("attention_nb", attn_bwd, lambda: fh.attention_nb_backward_reference(
        do_nb, q, k, v, o, lse, heads, dim_head), {})
    dqkv = fh._joined([a.reshape(t, inner) for a in attn_grads])
    if dqkv.data_ptr() != attn_grads[0].data_ptr():
        raise AssertionError(f"attention_nb backward {shape}: dq, dk, dv are not one buffer")

    def ln_bwd():
        return fh.ln_gemm_backward(dqkv, x, ln1[0], wqkv, eps)

    twice("ln_gemm", ln_bwd, lambda: fh.ln_gemm_backward_reference(dqkv, x, ln1[0], wqkv, eps),
          {})
    # Its GEMM is the LayerNorm-backward dgrad: no linear_kernel.
    rows["ln_gemm"], device["ln_gemm"] = check_ln_epilogue(
        torch, f"ln_gemm backward {shape}", ln_bwd, banned=("linear_kernel",))
    log(f"hybrid ln_gemm backward {shape}: device ms launch by launch "
        + "; ".join(f"{g} x{cnt:g} {ms:.4f}" for g, (ms, cnt) in rows["ln_gemm"].items())
        + f" on {smi}")
    # PyTorch's LayerNorm backward on the f32 dxn each keeps on chip.
    ln_lib = {"ln_gemm": ln_library(torch, fh.gemm_wgmma(dqkv, wqkv, "f32", layout="kn")[0], x,
                                    ln1[0], eps),
              "proj_mlp": ln_library(torch, fh.gemm_wgmma(dh, w1, "f32", layout="kn")[0], y,
                                     ln2[0], eps)}

    # The library compositions, bf16, with autograd for the backwards.
    leaf = {name: a.detach().requires_grad_() for name, a in dict(
        x=x, g1=ln1[0], b1n=ln1[1], wqkv=wqkv, q=q, k=k, v=v, o=o2, wo=wo, bo=bo, g2=ln2[0],
        b2n=ln2[1], w1=w1, b1=mlp_w[1], w2=w2, b2=mlp_w[3]).items()}

    def lib_ln_gemm(p):
        return F.linear(F.layer_norm(p["x"], (d,), p["g1"], p["b1n"], eps), p["wqkv"])

    def lib_attention(p):
        return sa.nb_merge(F.scaled_dot_product_attention(
            *(sa.nb_heads(p[c], heads) for c in "qkv"), scale=scale))

    def lib_proj_mlp(p):
        y_ = p["x"] + F.linear(p["o"], p["wo"], p["bo"])
        hid = F.gelu(F.linear(F.layer_norm(y_, (d,), p["g2"], p["b2n"], eps), p["w1"], p["b1"]))
        return y_ + F.linear(hid, p["w2"], p["b2"])

    def autograd(fn, cot, own, weights=()):
        out = fn(leaf)
        ins = [leaf[c] for c in own + weights]
        return lambda: torch.autograd.grad(out, ins, cot, retain_graph=True)

    cases = {
        "ln_gemm": (lambda: fh.ln_gemm(x, *ln1, wqkv, eps),
                    lambda: fh.ln_gemm_forward_reference(x, *ln1, wqkv, eps),
                    lambda: lib_ln_gemm(leaf)),
        "attention_nb": (lambda: fh.attention_nb(q, k, v, heads, dim_head),
                         lambda: fh.attention_nb_forward_reference(q, k, v, heads, dim_head),
                         lambda: lib_attention(leaf)),
        "proj_mlp": (lambda: fh.proj_mlp(x, o2, wo, bo, *ln2, *mlp_w, eps),
                     lambda: fh.proj_mlp_forward_reference(x, o2, wo, bo, *ln2, *mlp_w, eps),
                     lambda: lib_proj_mlp(leaf)),
    }
    backward = {
        "ln_gemm": (ln_bwd, lambda: fh.ln_gemm_backward_reference(dqkv, x, ln1[0], wqkv, eps),
                    lambda: (ln_bwd(), weight_grad(dqkv, xn1)),
                    autograd(lib_ln_gemm, dqkv, ("x", "g1", "b1n")),
                    autograd(lib_ln_gemm, dqkv, ("x", "g1", "b1n"), ("wqkv",))),
        "attention_nb": (attn_bwd, lambda: fh.attention_nb_backward_reference(
            do_nb, q, k, v, o, lse, heads, dim_head), None,
            autograd(lib_attention, do_nb, ("q", "k", "v")), None),
        "proj_mlp": (proj_bwd, lambda: fh.proj_mlp_backward_reference(
            dz, y, h, ln2[0], wo, w1, w2, eps),
            lambda: (proj_bwd(), weight_grad(dy, o2), weight_grad(dh, xn2), weight_grad(dz, gact)),
            autograd(lib_proj_mlp, dz, ("x", "o", "bo", "g2", "b2n", "b1", "b2")),
            autograd(lib_proj_mlp, dz, ("x", "o", "bo", "g2", "b2n", "b1", "b2"),
                     ("wo", "w1", "w2"))),
    }
    bounds = hybrid_bounds(b, n, d, heads, dim_head, hidden)
    for name, (kernel, plain, library) in cases.items():
        with torch.inference_mode():
            fwd_ms = interleaved_medians(torch, {"kernel": kernel, "plain": plain,
                                                 "library": library}, rounds=5, calls=5)
        bk, bp, bw, bl, blw = backward[name]
        fns = {"kernel": bk, "plain": bp, "library": bl}
        if bw is not None:
            fns.update(whole=bw, library_whole=blw)
        if name in ln_lib:
            fns.update(library_ln=ln_lib[name])
        bwd_ms = interleaved_medians(torch, fns, rounds=5, calls=5)
        fb, bb = bounds[name], bounds[name + "_bwd"]
        log(f"hybrid {name} {shape}: training forward within one bf16 unit plus "
            f"{KERNEL_REL_TOL}*max|its own part| of the plain version, max|kernel-plain|="
            f"{errs[name]:.6g}" + (f", lse {lse_err:.3g}" if name == "attention_nb" else "")
            + f"; backward fed the forward's residuals {errs[name + '_bwd']:.6g}, the same bits "
            f"in two runs; forward ms kernel={fwd_ms['kernel']:.4f} plain={fwd_ms['plain']:.4f} "
            f"library={fwd_ms['library']:.4f} bound={fb[0]:.4f} ({fb[1]}); backward ms kernel="
            f"{bwd_ms['kernel']:.4f} plain={bwd_ms['plain']:.4f} autograd through the library="
            f"{bwd_ms['library']:.4f}"
            + (f"; with the weight gradients: kernel+dW GEMMs={bwd_ms['whole']:.4f} autograd="
               f"{bwd_ms['library_whole']:.4f}" if bw is not None else "")
            + (f"; device ms a call {device[name]:.4f}, of it the LayerNorm-backward dgrad "
               f"{rows[name][LN_EPILOGUE][0]:.4f}; native_layer_norm_backward on the same "
               f"f32 dxn={bwd_ms['library_ln']:.4f}" if name in ln_lib else "")
            + f"; bound={bb[0]:.4f} ({bb[1]}) on {smi}")
        results.setdefault(name, {})[tag] = dict(err=errs[name], **fwd_ms, bound=fb)
        results.setdefault(name + "_bwd", {})[tag] = dict(
            err=errs[name + "_bwd"], **bwd_ms, bound=bb,
            **({"device": device[name]} if name in device else {}))


def hybrid_vit(fused_attention="hybrid", **kw):
    """``ViT`` with the short-sequence tier opted into (a caller's
    ``fused_attention`` overrides it: the plain path passes ``"never"``)."""
    from vit_tpu_torch import ViT

    return ViT(fused_attention=fused_attention, **kw)


def serving_phase(torch, tag, vit, cfg, batch, requests, seed, smi, counters, per_forward,
                  top1_sign_test=False, size=None, plain_kw=PLAIN_KW):
    """Serve ``requests`` batches of ``size`` px (``cfg["image_size"]`` by
    default) through the model class ``vit``; the plain path is ``vit`` with
    ``plain_kw``.  Each forward must launch each kernel ``per_forward[name]``
    times (0 if not named).  The kernel path must agree with the f32 reference's top-1 at
    least as often as the plain bf16 path does; with ``top1_sign_test``, for
    a model whose plain path keeps more precision than the kernel route
    (the small-dataset ViT's exact f32 LSA softmax), less often only by
    chance (SIGN_TEST_Z).  Returns each kernel's launches over them."""
    from vit_tpu_torch import cast_params

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = cast_params(vit(**cfg, device=dev, generator=g), torch.bfloat16).eval()
    plain = vit(**cfg, **plain_kw, device=dev, dtype=torch.bfloat16).eval()
    plain.load_state_dict(model.state_dict())
    size = size or cfg["image_size"]
    images = [torch.randn(batch, size, size, 3, generator=g, device=dev)
              for _ in range(requests)]

    with torch.inference_mode():
        # The main path's run: counters from 0, read right after.
        for c in counters.values():
            c.launches = 0
        outs = []
        for i, img in enumerate(images):
            outs.append(model(img))
            check_launches(tag, f"forward {i}", counters, per_forward, i + 1)
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        refs = [plain(img) for img in images]
        f32 = vit(**cfg, **plain_kw, device=dev, dtype=torch.float32).eval()
        f32.load_state_dict({k: v.float() for k, v in model.state_dict().items()})
        truths = [f32(img) for img in images]
        del f32
        torch.cuda.synchronize()

        logits, ref = torch.cat(outs).float(), torch.cat(refs).float()
        truth = torch.cat(truths)
        if tuple(outs[0].shape) != (batch, cfg["num_classes"]):
            raise AssertionError(f"{tag}: logits shape {tuple(outs[0].shape)}")
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{tag}: non-finite logits")
        err = (logits - ref).abs().max().item()
        tol = LOGIT_REL_TOL * ref.abs().max().item()
        err_k, err_p = ((t - truth).abs().max().item() for t in (logits, ref))

        def top1(a, b):
            return (a.argmax(-1) == b.argmax(-1)).float().mean().item()

        top1_kp, top1_kf, top1_pf = top1(logits, ref), top1(logits, truth), top1(ref, truth)
        right_k, right_p = (t.argmax(-1) == truth.argmax(-1) for t in (logits, ref))
        kernel_only = int((right_k & ~right_p).sum().item())
        plain_only = int((right_p & ~right_k).sum().item())
        slack = SIGN_TEST_Z * math.sqrt(kernel_only + plain_only)
        top2 = truth.topk(2, dim=-1).values
        margins = top2[:, 0] - top2[:, 1]
        margin = margins.median().item()
        confident = margins > 2 * err_p
        n_confident = int(confident.sum().item())
        top1_conf = top1(logits[confident], ref[confident]) if n_confident else 0.0
        ms = interleaved_medians(torch, {"kernels": lambda: model(images[0]),
                                         "plain": lambda: plain(images[0])},
                                 rounds=5, calls=4)
    log(f"serving {tag}: {requests} requests x {batch} images, logits "
        f"{tuple(outs[0].shape)} finite; kernel launches per forward {per_forward}; "
        f"max|kernel-plain|={err:.6g} tol={tol:.6g} (1e-1*max|ref|); "
        f"vs f32 reference max|kernel-f32|={err_k:.6g} max|plain-f32|={err_p:.6g} "
        f"(kernel <= {MAX_ERR_VS_PLAIN_BF16}x plain); top-1 agreement "
        f"kernel/plain={top1_kp:.4f} kernel/f32={top1_kf:.4f} plain/f32={top1_pf:.4f} ("
        + (f"sign test: images where only the kernel path / only the plain path has f32's "
           f"top-1 {kernel_only} / {plain_only}, plain-only minus kernel-only <= "
           f"{SIGN_TEST_Z}*sqrt(their sum) = {slack:.3g}" if top1_sign_test
           else "kernel/f32 >= plain/f32")
        + f"); median top-2 margin of the f32 logits "
        f"{margin:.4g}; kernel/plain top-1 over the {n_confident} images with an "
        f"f32 margin above 2*max|plain-f32| = {top1_conf:.4f} (>= {TOP1_CONFIDENT}); "
        f"median forward ms kernels={ms['kernels']:.3f} "
        f"plain={ms['plain']:.3f} ({batch / ms['kernels'] * 1e3:.1f} vs "
        f"{batch / ms['plain'] * 1e3:.1f} img/s) on {smi}")
    if not err <= tol:
        raise AssertionError(f"{tag}: logits differ by {err} > {tol}")
    if not err_k <= MAX_ERR_VS_PLAIN_BF16 * err_p:
        raise AssertionError(f"{tag}: kernel path {err_k} from the f32 reference, "
                             f"plain bf16 path {err_p}")
    if top1_sign_test and plain_only - kernel_only > slack:
        raise AssertionError(f"{tag}: top-1 agreement with the f32 reference {top1_kf} below "
                             f"the plain bf16 path's {top1_pf} beyond chance: only the plain "
                             f"path right on {plain_only} images, only the kernel path on "
                             f"{kernel_only}")
    if not top1_sign_test and top1_kf < top1_pf:
        raise AssertionError(f"{tag}: top-1 agreement with the f32 reference {top1_kf} < "
                             f"the plain bf16 path's {top1_pf}")
    if not (n_confident and top1_conf >= TOP1_CONFIDENT):
        raise AssertionError(f"{tag}: kernel/plain top-1 agreement {top1_conf} over "
                             f"{n_confident} confident images, need {TOP1_CONFIDENT}")
    return launches


def check_launches(tag, when, counters, expected, times):
    """Each counter must read ``times · expected[name]`` (0 when unnamed)."""
    got = {name: c.launches for name, c in counters.items()}
    want = {name: times * expected.get(name, 0) for name in counters}
    if got != want:
        raise AssertionError(f"{tag}: after {when} the kernels were launched {got} times, "
                             f"expected {want}")


def rel_l2(torch, a, ref):
    return (torch.linalg.vector_norm((a - ref).float())
            / torch.linalg.vector_norm(ref.float()).clamp_min(1e-30)).item()


def training_models(torch, vit, cfg, batch, seed, size=None, plain_kw=PLAIN_KW):
    """The kernel path ``vit(..., compute_dtype=bf16)`` with f32 parameters
    from a seeded initialisation, the plain bf16 path (``plain_kw``) and the
    f32 model on the same weights, and one seeded batch of images of ``size``
    px (``cfg["image_size"]`` by default) and labels."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = vit(**cfg, compute_dtype=torch.bfloat16, generator=g)
    plain = vit(**cfg, compute_dtype=torch.bfloat16, **plain_kw)
    f32 = vit(**cfg, **plain_kw)
    for twin in (plain, f32):
        twin.load_state_dict(model.state_dict())
    size = size or cfg["image_size"]
    images = torch.randn(batch, size, size, 3, generator=g, device=dev)
    labels = torch.arange(batch, device=dev) % cfg["num_classes"]
    return model, plain, f32, images, labels


def check_temperatures(torch, tag, grads, weights):
    """Hold each LSA temperature's step-1 gradient (a 0-d ``…attn.temperature``)
    on the kernel path within TEMPERATURE_TERMS_TOL·Σ|dWq⊙Wq| of the f32
    model's: Wq the q-third of the same layer's ``to_qkv.weight``
    (``weights``, the f32 model's parameters), dWq its gradient in the f32
    model, whose Σ dWq⊙Wq is the temperature's gradient (held to the same
    bound, so that the terms are the right ones).  Returns a summary for
    the log, empty without temperatures; raises on a miss."""
    rows, misses = [], []
    for k in sorted(k for k, v in grads["f32"].items() if v.dim() == 0):
        w = k.rsplit(".", 1)[0] + ".to_qkv.weight"
        inner = weights[w].shape[0] // 3
        terms = grads["f32"][w][:inner] * weights[w][:inner]
        total, size = terms.sum().item(), terms.abs().sum().item()
        ref = grads["f32"][k].item()
        err_k, err_p = (abs(grads[n][k].item() - ref) for n in ("kernels", "plain"))
        rows.append(f"{k.split('.attn')[0]} f32 {ref:.6g} (Σ dWq⊙Wq {total:.6g}) kernels "
                    f"{grads['kernels'][k].item():.6g} plain {grads['plain'][k].item():.6g} "
                    f"Σ|terms| {size:.6g} |error|/Σ|terms| kernels {err_k / size:.3g} plain "
                    f"{err_p / size:.3g}")
        if not (err_k <= TEMPERATURE_TERMS_TOL * size
                and abs(total - ref) <= TEMPERATURE_TERMS_TOL * size):
            misses.append(rows[-1])
    if misses:
        raise AssertionError(f"{tag}: temperature gradients beyond {TEMPERATURE_TERMS_TOL} of "
                             f"their terms: {misses}")
    return (f"temperatures (each within {TEMPERATURE_TERMS_TOL:.4g}*Σ|terms| of f32): "
            + "; ".join(rows) + "; ") if rows else ""


def step1_gradients(torch, tag, models, images, labels):
    """Step-1 gradients of the kernel path, the plain bf16 path and the f32
    model (``models``, in that order, on the same weights): each parameter's
    on the kernel path within MAX_GRAD_ERR_VS_PLAIN_BF16 times the plain
    path's relative L2 error against f32, the 0-d ones as one stacked
    vector and each by :func:`check_temperatures`.  Returns the first
    losses and a summary for the log; raises on a miss."""
    from vit_tpu_torch.parallel.train import cross_entropy_loss

    if any(p.dtype != torch.float32 for p in models[0].parameters()):
        raise AssertionError(f"{tag}: parameters are not f32")
    grads, first, peak = {}, {}, {}
    for name, m in zip(("kernels", "plain", "f32"), models):
        m.train().zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        loss = cross_entropy_loss(m(images), labels)
        loss.backward()
        first[name] = loss.item()
        peak[name] = torch.cuda.max_memory_allocated() / 1e9
        grads[name] = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
    if any(v.dtype != torch.float32 for v in grads["kernels"].values()):
        raise AssertionError(f"{tag}: gradients are not f32")
    temperatures = check_temperatures(torch, tag, grads, dict(models[2].named_parameters()))
    scalars = sorted(k for k, v in grads["f32"].items() if v.dim() == 0)
    for name in grads:
        held = {k: v for k, v in grads[name].items() if k not in scalars}
        if scalars:
            held["0-d parameters of every layer, stacked"] = torch.stack(
                [grads[name][k] for k in scalars])
        grads[name] = held
    worst_ratio, worst_name, misses = 0.0, "", []
    for k, ref in grads["f32"].items():
        err_k, err_p = (rel_l2(torch, grads[n][k], ref) for n in ("kernels", "plain"))
        ratio = err_k / max(err_p, 1e-30)
        if ratio > worst_ratio:
            worst_ratio, worst_name = ratio, k
        if not err_k <= MAX_GRAD_ERR_VS_PLAIN_BF16 * err_p:
            misses.append(f"{k}: {err_k:.4g} vs plain {err_p:.4g}")
    cat = {n: torch.cat([v.flatten() for v in grads[n].values()]) for n in grads}
    all_k, all_p = (rel_l2(torch, cat[n], cat["f32"]) for n in ("kernels", "plain"))
    summary = (f"step-1 gradients, relative L2 error against the f32 model over all "
               f"parameters: kernels={all_k:.4g} plain={all_p:.4g}; worst per-tensor ratio "
               f"kernels/plain={worst_ratio:.3f} ({worst_name}; <= "
               f"{MAX_GRAD_ERR_VS_PLAIN_BF16}); peak GB allocated in the step-1 forward and "
               f"backward (the three models' weights included) kernels={peak['kernels']:.2f} "
               f"plain={peak['plain']:.2f} f32={peak['f32']:.2f}; {temperatures}")
    if misses:
        raise AssertionError(f"{tag}: kernel-path gradients beyond "
                             f"{MAX_GRAD_ERR_VS_PLAIN_BF16}x the plain path's error: {misses}; "
                             f"{summary}")
    return first, summary


def gradient_phase(torch, tag, vit, cfg, batch, seed, smi):
    """:func:`step1_gradients` at another seed than the training phase's."""
    model, plain, f32, images, labels = training_models(torch, vit, cfg, batch, seed)
    first, summary = step1_gradients(torch, tag, (model, plain, f32), images, labels)
    log(f"gradients {tag}: batch {batch}, seed {seed}; step-1 loss kernels="
        f"{first['kernels']:.6f} plain={first['plain']:.6f} f32={first['f32']:.6f}; {summary}"
        f"on {smi}")


def training_phase(torch, tag, vit, cfg, batch, seed, smi, counters, per_step, size=None,
                   plain_kw=PLAIN_KW, timing=None):
    """Train ``vit(..., compute_dtype=bf16)`` (f32 parameters) with SGD on one
    fixed batch; hold its step-1 gradients (:func:`step1_gradients`) and its
    loss against the plain bf16 path (``plain_kw``) and an f32 model of the
    same weights; check that each step launches each kernel
    ``per_step[name]`` times (0 if not named), and that BatchNorm's running
    statistics, where the model has them, stay finite and move; time a step
    on both paths (:func:`interleaved_medians` with ``timing``, 3 rounds of
    3 steps by default)."""
    from vit_tpu_torch.parallel.train import make_train_step

    model, plain, f32, images, labels = training_models(torch, vit, cfg, batch, seed, size,
                                                        plain_kw)
    first, summary = step1_gradients(torch, tag, (model, plain, f32), images, labels)
    del f32
    torch.cuda.empty_cache()
    loss_rel = abs(first["kernels"] - first["plain"]) / abs(first["plain"])

    # The main path: counters from 0, TRAIN_STEPS steps, read right after.
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    stats = {k: b.clone() for k, b in model.named_buffers() if "running" in k}
    for c in counters.values():
        c.launches = 0
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append(step(images, labels)["loss"].item())
        check_launches(tag, f"step {i}", counters, per_step, i + 1)
    launches = {name: c.launches for name, c in counters.items()}
    buffers = dict(model.named_buffers())
    stale = [k for k, before in stats.items() if torch.equal(buffers[k], before)
             or not bool(torch.isfinite(buffers[k]).all())]
    if stale:
        raise AssertionError(f"{tag}: BatchNorm statistics not finite or not updated: {stale}")
    plain_step = make_train_step(plain, torch.optim.SGD(plain.parameters(), lr=1e-3))
    ms = interleaved_medians(torch, {"kernels": lambda: step(images, labels),
                                     "plain": lambda: plain_step(images, labels)},
                             **(timing or dict(rounds=3, calls=3)))
    STEP_MS[tag] = ms
    log(f"training {tag}: batch {batch}, f32 params, bf16 compute, SGD(1e-3); step-1 loss "
        f"kernels={first['kernels']:.6f} plain={first['plain']:.6f} f32={first['f32']:.6f} "
        f"(kernels/plain within {LOSS_REL_TOL} relative: {loss_rel:.3g}); {summary}losses "
        f"over {TRAIN_STEPS} steps {[round(v, 6) for v in losses]}; launches per step "
        f"{per_step}; peak GB since the f32 model's step 1, both paths' timed steps "
        f"included: allocated {torch.cuda.max_memory_allocated() / 1e9:.2f}, reserved "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f}, of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}; "
        + (f"{len(stats)} BatchNorm running statistics finite and updated; " if stats else "")
        + f"median step ms kernels={ms['kernels']:.3f} "
        f"plain={ms['plain']:.3f} ({batch / ms['kernels'] * 1e3:.1f} vs "
        f"{batch / ms['plain'] * 1e3:.1f} img/s) on {smi}")
    if not loss_rel <= LOSS_REL_TOL:
        raise AssertionError(f"{tag}: first losses differ by {loss_rel} relative")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite and falling")
    return launches


# csrc/kernels.cuh Epilogue, for the names of the linear_kernel instances.
EPILOGUES = {0: "store (QKV, doattn)", 1: "bias+GELU", 2: "bias+residual (out-proj, fc2)",
             3: "bias+GELU, keeps h (fc1)", 4: "dGELU (dy·W2)", 5: "f32 out (dxn)",
             6: "LN backward (dxn on chip)"}
# The dgrad whose epilogue is the LayerNorm backward, and the LayerNorm
# backward's passes over a stored f32 dxn that it replaces.
LN_EPILOGUE = "gemm_wgmma_kernel " + EPILOGUES[6]
LN_PASSES = ("ln_bwd_rows_kernel", "ln_bwd_cols_kernel")
PROFILE_STEPS = 5  # profiled steps, after 3 of warm-up


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's own kernels by role, the rest by
    kind."""
    m = re.search(r"linear_kernel<[^,]+, (\d+), (\d+)>", name)
    if m:
        return f"linear_kernel {EPILOGUES.get(int(m.group(1)), m.group(1))}"
    m = re.search(r"(flash_\w+_kernel)<[^,]+, (\d+), (\d+)>", name)
    if m:
        return f"{m.group(1)} (dk {m.group(2)}, dv {m.group(3)})"
    m = re.search(r"(short_\w+_kernel)<[^,]+, (\d+)(?:, (\d+))?(?:, \d+)?(, true)?(?:, false)?>",
                  name)
    if m:
        return f"{m.group(1)} (d {m.group(2)}" + (f", {m.group(3)}-key tiles" if m.group(3)
                                                  else "") + (", bias)" if m.group(4) else ")")
    m = re.search(r"(cross_fwd_kernel|cross_bwd_kernel)<[^,]+, (\d+), (\d+), \d+>", name)
    if m:
        return f"{m.group(1)} (dk {m.group(2)}, dv {m.group(3)})"
    if "cross_bwd_reduce_kernel" in name:  # before PyTorch's reductions
        return "cross_bwd_reduce_kernel"
    m = re.search(r"gemm_wgmma_kernel<[^,]+, (\d+)(?:, \d+)?>", name)
    if m:  # before the library's GEMMs: its name holds "gemm"
        return f"gemm_wgmma_kernel {EPILOGUES.get(int(m.group(1)), m.group(1))}"
    m = re.search(r"mha_fwd_kernel<[^,]+, \d+, (true|false)>", name)
    if m:  # <T, dim_head, BIAS>
        return "mha_fwd_kernel" + (" (bias)" if m[1] == "true" else "")
    for own in ("mha_fwd_kernel", "mha_bwd_dq_kernel", "mha_bwd_dkv_kernel",
                "mha_bwd_dbias_kernel", "ln_bwd_rows_kernel", "ln_bwd_cols_kernel",
                "layernorm_kernel", "colsum_kernel", "rows_cols_kernel", "flash_bwd_dsum_kernel",
                "short_dq_sum_kernel"):
        if own in name:
            return own + (" (bias)" if "true>" in name else "")
    if re.search(r"conv|fprop|dgrad|wgrad", name, re.I):
        return ("cuDNN convolutions (SPT; CvT's embeddings and depthwise projections; "
                "ScalableViT's stem, k/v reductions, local modules, PEG, downsampling)")
    if re.search(r"gemm|xmma|cutlass|sm90_|nvjet", name, re.I):
        return "cuBLAS GEMM (dW, patch embedding, head; 1x1 convs outside the kernels)"
    if "multi_tensor_apply" in name or "foreach" in name.lower():
        return "optimizer (foreach)"
    if re.search(r"layer_norm|LayerNorm", name):
        return "PyTorch layer_norm (CvT's channel LayerNorms)"
    if re.search(r"batch_norm|batchnorm", name, re.I):
        return "PyTorch batch_norm (CvT's projections)"
    if "elementwise" in name:
        return "PyTorch elementwise (casts, adds, GELU, pads)"
    if "reduce" in name.lower():
        return "PyTorch reductions (statistics, loss, bias gradients)"
    return "other PyTorch kernels (copies, embedding, loss)"


def profile_phase(torch, tag, vit, cfg, batch, seed, smi, size=None, ln_epilogues=None,
                  ln_passes=False):
    """Where a train step's device time goes: ``torch.profiler`` over a few
    steps of the training path.  Prints the wall time per step (host clock
    around synchronised steps, profiler off and on), the device's busy time
    per step (the sum of its kernel times: one stream, so kernels do not
    overlap), the idle share against either wall time, the host's enqueue
    time per step (until ``step`` returns, before the synchronise: a step
    whose enqueue time is its wall time is host-bound), the synchronising
    calls in one step (``torch.cuda.set_sync_debug_mode("warn")``), and the
    kernels grouped by what they do, with their time and launches per step.
    A first one-step profile, thrown away, takes the profiler's start-up out
    of the timed one.  Only the device's activity is recorded: the host's
    ops would add tens of thousands of events a step to process at a
    launch-bound config, and its time is the enqueue time above.  With
    ``ln_epilogues``, raises unless a step launches the LayerNorm-backward
    dgrad that many times and, unless ``ln_passes``, none of layernorm.cu's
    backward passes."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch.parallel.train import make_train_step

    g = torch.Generator(device="cuda").manual_seed(seed)
    model = vit(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    size = size or cfg["image_size"]
    images = torch.randn(batch, size, size, 3, generator=g, device="cuda")
    labels = torch.arange(batch, device="cuda") % cfg["num_classes"]
    for _ in range(3):
        step(images, labels)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        step(images, labels)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        t1 = time.perf_counter()
        step(images, labels)
        enqueue.append((time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CUDA]):
        step(images, labels)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_STEPS):
            step(images, labels)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    groups = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, count = groups.get(kernel_group(evt.key), (0.0, 0.0))
        groups[kernel_group(evt.key)] = (ms + evt.self_device_time_total / 1e3 / PROFILE_STEPS,
                                         count + evt.count / PROFILE_STEPS)
    busy = sum(ms for ms, _ in groups.values())
    if busy <= 0:
        log(f"profile {tag}: the profiler saw no device time; not measured")
        return
    log(f"profile {tag}: batch {batch}, f32 params, bf16 compute, SGD, {PROFILE_STEPS} "
        f"steps on {smi}; wall ms/step {wall_ms:.3f} (profiler off), {prof_wall_ms:.3f} "
        f"(profiler on); device busy ms/step {busy:.3f}; idle share "
        f"{1 - busy / wall_ms:.3f} against the profiler-off wall time, "
        f"{1 - busy / prof_wall_ms:.3f} against the profiler-on one; host enqueue ms/step "
        f"median {statistics.median(enqueue):.3f} (profiler off); synchronising calls in "
        f"one step: {len(syncs)}")
    log("| kernels | ms / step | launches / step |")
    log("|---|---|---|")
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"| {name} | {ms:.3f} | {count:g} |")
    if ln_epilogues is not None:
        launches = groups.get(LN_EPILOGUE, (0.0, 0.0))[1]
        passes = [g for g in LN_PASSES if g in groups]
        if round(launches) != ln_epilogues or (passes and not ln_passes):
            raise AssertionError(f"profile {tag}: {launches:g} launches of {LN_EPILOGUE} a step "
                                 f"({ln_epilogues} expected)"
                                 + (f", and {passes}" if passes and not ln_passes else ""))


def kernel_entry(results, by_path, name, src, tpu, main_shape):
    """A kernel's line of the JSON summary: its launches over the main paths
    ``by_path`` (and per path), its largest error over every check, and its
    times and bound at ``main_shape`` (the block kernels' B/16, the biased
    block's small-dataset shape with LSA's bias, the flash kernels'
    CvT-13@224 stage 1, the cross-attention block's ScalableViT stage 1, the
    packed op's IWSA stage 1), its other timed shapes or biases under
    ``by_shape`` / ``by_bias``.  The block forwards' library call is
    PyTorch's bf16 modules, the block backwards' autograd through them for
    the kernel's own outputs (with the weight gradients beside the kernel
    plus its dW GEMMs); the flash kernels' is PyTorch's
    ``scaled_dot_product_attention`` (autograd through it for the backward);
    the cross-attention block's F.linear + SDPA + F.linear.  The flash
    backward's times through the packed op are under ``packed``."""
    kinds = results[name]
    r = kinds[main_shape]
    line = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(counts[name] for counts in by_path.values()),
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
            "max_abs_err": max(max(k.get("err", 0.0), k.get("train_fwd_err", 0.0))
                               for k in kinds.values()),
            "ms": r["kernel"], "plain_ms": r["plain"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library", r.get("modules")),
            "shape": main_shape}
    if "whole" in r:
        line.update(whole_ms=r["whole"], library_whole_ms=r["library_whole"])
    if "device" in r:  # the backwards whose LayerNorm backward is the dgrad's epilogue
        line.update(device_ms=r["device"])
    if "library_ln" in r:
        line.update(library_ln_ms=r["library_ln"])

    def table(rows):  # the timed records (a training forward's check has no times)
        return {tag: {k: v for k, v in k_r.items() if k != "bound"}
                | {"bound_ms": k_r["bound"][0]} for tag, k_r in rows.items() if "bound" in k_r}

    if len(table(kinds)) > 1:
        line["by_bias" if "bias" in name else "by_shape"] = table(kinds)
    if name in ("flash_attention", "flash_backward"):
        line["below_gate"] = {tag: times["forward" if name == "flash_attention" else "backward"]
                              for tag, times in results["below_gate"].items()}
    if name == "flash_backward":
        line["packed"] = table(results["flash_backward (packed)"])
    if name in ("fused_attention_block_bias", "fused_attention_block_bias_bwd"):
        # the biased block below the threshold on both routes (mha_route_phase)
        way = "forward" if name == "fused_attention_block_bias" else "backward"
        line["route_threshold_ms"] = {
            tag: {route: ms[f"{route} {way}"] for route in ("short", "mha")}
            for tag, ms in results["route threshold"].items()}
    if name in ("fused_attention_block", "fused_attention_block_bwd"):
        # the routes of both blocks (biased and not), forward and backward
        suffix = ", forward" if name == "fused_attention_block" else ""
        line["launches_by_route"] = {
            route: sum(counts[route + suffix] for counts in by_path.values())
            for route in ("short route", "mha route")}
    if name in DESIGNS:
        line["design"] = DESIGNS[name]
    return line


def ptxas_report(build_log: str) -> dict:
    """ptxas's registers, static shared memory and spill bytes of each
    instance of the wgmma+tma kernels, from the build's ``-Xptxas -v`` log:
    ``{"flash_bwd_dkv_kernel<bf16,64,64>": "212 registers, 0 bytes smem,
    0/0 bytes spilled (stores/loads)", ...}``."""
    report, name = {}, None
    pattern = re.compile(r"(flash_fwd_kernel|flash_bwd_dq_kernel|flash_bwd_dkv_kernel|"
                         r"short_fwd_kernel|short_bwd_kernel|short_bwd_wg_kernel|gemm_wgmma_kernel|"
                         r"cross_fwd_kernel|cross_bwd_kernel)I(6__half|13__nv_bfloat16)"
                         r"((?:L[ib]\d+E)*)")
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            m = pattern.search(line)
            name = m and ",".join([f"{m[1]}<{'f16' if m[2] == '6__half' else 'bf16'}",
                                   *(v if kind == "i" else "bias" for kind, v in
                                     re.findall(r"L([ib])(\d+)E", m[3])
                                     if kind == "i" or v == "1")]) + ">"
            spill = None
        elif name and "spill stores" in line:
            spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
        elif name and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            smem = re.search(r"(\d+) bytes smem", line)
            report[name] = (f"{regs} registers, {smem[1] if smem else 0} bytes smem, "
                            f"{'/'.join(spill or ['?', '?'])} bytes spilled (stores/loads)")
            name = None
    return report


def main() -> int:
    # ScalableViT's plain training path peaks at 72 GB of the card's 80 (its
    # stage-1 IWSA keeps (64, 2, 4096, 4096) score maps for the backward);
    # beside the blocks the kernel path's steps leave in PyTorch's cache,
    # fixed-size segments fragment and a 16 GiB request fails.  Growable
    # segments avoid that.  Set before CUDA starts.
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    from vit_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s); TF32 off")

    t0 = time.perf_counter()
    path, build_log = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    regs = [int(line.split("Used ")[1].split()[0])
            for line in build_log.splitlines() if "Used " in line and "registers" in line]
    spills = sum("0 bytes spill stores" not in line
                 for line in build_log.splitlines() if "spill stores" in line)
    log(f"build: {build_s:.2f} s, {path.name}, {len(regs)} kernels compiled, "
        f"max {max(regs, default=0)} registers, {spills} with spills")
    log(f"ptxas, the wgmma+tma kernels (dynamic shared memory is set at launch): "
        f"{json.dumps(ptxas_report(build_log))}")

    from vit_tpu_torch import CvT, ScalableViT, ViT
    from vit_tpu_torch.models import vit_for_small_dataset
    from vit_tpu_torch.ops.flash_attention import flash_attention, flash_backward
    from vit_tpu_torch.ops.flash_attention_packed import flash_attention_packed
    from vit_tpu_torch.ops.fused_attention_block import (
        BACKWARD_ROUTES, FORWARD_ROUTES, fused_attention_block, fused_attention_block_backward,
        fused_attention_block_bias, fused_attention_block_bias_backward,
    )
    from vit_tpu_torch.ops.fused_cross_attention import (
        BACKWARD_ROUTES as CROSS_BACKWARD_ROUTES, fused_cross_attention,
        fused_cross_attention_backward,
    )
    from vit_tpu_torch.ops.fused_hybrid import (
        attention_nb, attention_nb_backward, ln_gemm, ln_gemm_backward, proj_mlp,
        proj_mlp_backward,
    )
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_backward
    from vit_tpu_torch.ops.short_attention import short_attention, short_attention_backward

    results = {}
    with clock("forward GEMMs"):
        gemms = forward_gemm_phase(torch, smi)
    log(f"forward GEMMs, ms by kernel at each shape (launch_forward_gemm: gemm_wgmma from n = "
        f"{FORWARD_GEMM_MIN_N}, linear.cu below) on {smi}: {json.dumps(gemms)}")
    with clock("block kernels, SPT"):
        kernel_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
        kernel_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results)
        kernel_phase(torch, "B/32-entry", 8, 65, 1024, 16, 64, 2048, results)
        backward_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
        backward_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results)
        biased_phase(torch, 64, 257, 1024, 16, 64, 2048, results)
        spt_phase(torch, 64, 256, 16, 1024, smi)
    with clock("flash kernels"):
        flash_phase(torch, results, smi)
        below_gate_phase(torch, results, smi)
    with clock("cross-attention block"):
        cross_attention_phase(torch, results, smi)
    with clock("packed flash"):
        packed_phase(torch, results, smi)
    with clock("hybrid kernels"):
        hybrid_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results, smi)

    # The main paths, each with the counters from 0 just before it and read
    # just after.
    counters = {"fused_attention_block": fused_attention_block, "fused_mlp": fused_mlp,
                "fused_attention_block_bwd": fused_attention_block_backward,
                "fused_mlp_bwd": fused_mlp_backward,
                "fused_attention_block_bias": fused_attention_block_bias,
                "fused_attention_block_bias_bwd": fused_attention_block_bias_backward,
                # the blocks' attention middles by route (fused_attention_block.py
                # attention_route), each direction: short_fwd / short_bwd up to 512 tokens,
                # with or without a bias, else mha_fwd / mha_bwd (no main path has more:
                # every path holds them at 0)
                "short route": BACKWARD_ROUTES["short"], "mha route": BACKWARD_ROUTES["mha"],
                "short route, forward": FORWARD_ROUTES["short"],
                "mha route, forward": FORWARD_ROUTES["mha"],
                "flash_attention": flash_attention, "flash_backward": flash_backward,
                "fused_cross_attention": fused_cross_attention,
                "fused_cross_attention_bwd": fused_cross_attention_backward,
                # its backward by route (fused_cross_attention.py backward_route): one
                # cross_bwd kernel up to 128 channels, cross_bwd between gemm_wgmma's
                # dgrads from 129 (the four steps past 128 keys run on no main path:
                # the cross-attention phase holds them at 384 px)
                "cross backward, one kernel": CROSS_BACKWARD_ROUTES[1],
                "cross backward, split": CROSS_BACKWARD_ROUTES[2],
                "flash_attention_packed": flash_attention_packed,
                "short_attention": short_attention,
                "short_attention_bwd": short_attention_backward,
                "ln_gemm": ln_gemm, "ln_gemm_bwd": ln_gemm_backward,
                "attention_nb": attention_nb, "attention_nb_bwd": attention_nb_backward,
                "proj_mlp": proj_mlp, "proj_mlp_bwd": proj_mlp_backward}

    def per_layer(cfg, *names):
        return {name: cfg["depth"] for name in names}

    def path(name, phase, *args, **kwargs):
        torch.cuda.empty_cache()
        with clock(name):
            by_path[name] = phase(torch, *args, **kwargs)

    small = vit_for_small_dataset.ViT
    by_path = {}
    # The explicit-use op: its public entry under autograd, then its checks.
    path("short attention", short_attention_phase, results, smi, counters)
    path("serving B/16", serving_phase, "ViT-B/16@224 bf16", ViT, B16, 64, 3, 0, smi, counters,
         per_layer(B16, "fused_attention_block", "fused_mlp", "short route, forward"))
    path("serving B/32", serving_phase, "ViT-B/32@256 bf16 (entry)", ViT, ENTRY, 8, 3, 1, smi,
         counters, per_layer(ENTRY, "fused_attention_block", "fused_mlp", "short route, forward"))
    path("serving small-dataset", serving_phase, "small-dataset ViT 256/16 bf16", small,
         SMALL_DATASET, 64, 3, 4, smi, counters,
         per_layer(SMALL_DATASET, "fused_attention_block_bias", "fused_mlp",
                   "short route, forward"),
         top1_sign_test=True)
    path("training B/32", training_phase, "ViT-B/32@256 (bench.py)", ViT, ENTRY, 128, 2, smi,
         counters, per_layer(ENTRY, "fused_attention_block", "fused_mlp",
                             "fused_attention_block_bwd", "fused_mlp_bwd", "short route",
                             "short route, forward"))
    # The short-sequence tier (fused_attention="hybrid") at bench.py's model.
    hybrid = per_layer(ENTRY, "ln_gemm", "attention_nb", "proj_mlp")
    path("serving B/32 hybrid", serving_phase, "ViT-B/32@256 hybrid bf16", hybrid_vit, ENTRY,
         128, 3, 1, smi, counters, hybrid)
    path("training B/32 hybrid", training_phase, "ViT-B/32@256 hybrid (bench.py)", hybrid_vit,
         ENTRY, 128, 2, smi, counters,
         {**hybrid, **per_layer(ENTRY, "ln_gemm_bwd", "attention_nb_bwd", "proj_mlp_bwd")})
    rows, tier = STEP_MS["ViT-B/32@256 (bench.py)"], STEP_MS["ViT-B/32@256 hybrid (bench.py)"]
    log(f"B/32 train step, batch 128, median ms: hybrid tier {tier['kernels']:.3f} against "
        f"rows 1-4 {rows['kernels']:.3f} (plain path {tier['plain']:.3f} and "
        f"{rows['plain']:.3f} in the two phases) on {smi}")
    path("training B/16", training_phase, "ViT-B/16@224", ViT, B16, 64, 3, smi, counters,
         per_layer(B16, "fused_attention_block", "fused_mlp", "fused_attention_block_bwd",
                   "fused_mlp_bwd", "short route", "short route, forward"))
    path("training small-dataset", training_phase, "small-dataset ViT 256/16", small,
         SMALL_DATASET, 64, 5, smi, counters,
         per_layer(SMALL_DATASET, "fused_attention_block_bias", "fused_mlp",
                   "fused_attention_block_bias_bwd", "fused_mlp_bwd", "short route",
                   "short route, forward"))
    with clock("gradients small-dataset"):
        gradient_phase(torch, "small-dataset ViT 256/16", small, SMALL_DATASET, 64, 6, smi)
    # CvT-13: flash at stage 1 (224 px; n_q 3136, n_k 784), stages 1 and 2 (384 px).
    cvt = dict(plain_kw=dict(use_flash="never"))
    for size, flash in ((224, 1), (384, 3)):
        path(f"serving CvT-13@{size}", serving_phase, f"CvT-13@{size} bf16", CvT, CVT13, 64, 3,
             7, smi, counters, {"flash_attention": flash}, size=size, **cvt)
        path(f"training CvT-13@{size}", training_phase, f"CvT-13@{size}", CvT, CVT13, 64, 8, smi,
             counters, {"flash_attention": flash, "flash_backward": flash}, size=size, **cvt)
    # ScalableViT: the cross-attention block in every SSA, the packed flash op
    # in every IWSA whose window holds 1024 tokens or more (stages 1 and 2),
    # two conv-MLPs per block.  Its plain path takes 1.0-1.7 s a step at
    # batch 64 (H100 80GB HBM3, 700 W), so its step is timed in 3 rounds of
    # one step after one of warm-up.
    blocks = sum(SCALABLE["depth"])
    windows = [SCALABLE_SIZE // 4 // 2 ** i if w is None else w
               for i, w in enumerate(SCALABLE["window_size"])]
    packed = sum(d for d, w in zip(SCALABLE["depth"], windows) if w * w >= 1024)
    scalable_forward = {"fused_cross_attention": blocks, "flash_attention_packed": packed,
                        "fused_mlp": 2 * blocks}
    path("serving ScalableViT", serving_phase, "ScalableViT@256 bf16", ScalableViT, SCALABLE,
         64, 3, 9, smi, counters, scalable_forward, size=SCALABLE_SIZE)
    one_kernel = sum(d for i, d in enumerate(SCALABLE["depth"]) if SCALABLE["dim"] << i <= 128)
    path("training ScalableViT", training_phase, "ScalableViT@256", ScalableViT, SCALABLE, 64,
         10, smi, counters,
         {**scalable_forward, "fused_cross_attention_bwd": blocks, "flash_backward": packed,
          "fused_mlp_bwd": 2 * blocks, "cross backward, one kernel": one_kernel,
          "cross backward, split": blocks - one_kernel}, size=SCALABLE_SIZE,
         timing=dict(rounds=3, calls=1, warmup=1))
    # The blocks past 512 tokens: the mha route's path, then its kernels' checks.
    path("mha route", mha_route_phase, results, smi, counters)
    torch.cuda.empty_cache()
    with clock("profiles"):
        # The LayerNorm-backward dgrad: rows 2 and 4 (or 5) of every ViT
        # layer, rows 12 and 14 on the hybrid tier, with no layernorm.cu
        # backward pass; ScalableViT's conv-MLPs at stages 3-4 (256 and 512
        # channels: d % 256 == 0), its narrower stages and its cross-attention
        # blocks on the passes; none at CvT's widths.
        two = 2 * ENTRY["depth"]
        profile_phase(torch, "ViT-B/32@256 (bench.py)", ViT, ENTRY, 128, 0, smi,
                      ln_epilogues=two)
        profile_phase(torch, "ViT-B/32@256 hybrid (bench.py)", hybrid_vit, ENTRY, 128, 0, smi,
                      ln_epilogues=two)
        profile_phase(torch, "ViT-B/16@224", ViT, B16, 64, 0, smi, ln_epilogues=2 * B16["depth"])
        profile_phase(torch, "small-dataset ViT 256/16", small, SMALL_DATASET, 64, 0, smi,
                      ln_epilogues=2 * SMALL_DATASET["depth"])
        profile_phase(torch, "CvT-13@224", CvT, CVT13, 64, 0, smi, size=224, ln_epilogues=0,
                      ln_passes=True)
        profile_phase(torch, "CvT-13@384", CvT, CVT13, 64, 0, smi, size=384, ln_epilogues=0,
                      ln_passes=True)
        wide = sum(2 * depth for i, depth in enumerate(SCALABLE["depth"])
                   if (SCALABLE["dim"] << i) % 256 == 0)
        profile_phase(torch, "ScalableViT@256", ScalableViT, SCALABLE, 64, 0, smi,
                      size=SCALABLE_SIZE, ln_epilogues=wide, ln_passes=True)
    log(f"wall seconds by phase (build {build_s:.2f} before them): {json.dumps(WALL)}")

    # name: (source, the TPU kernel it replaces, the shape of its times)
    sources = {
        "fused_mlp": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:147", "B/16"),
        "fused_attention_block": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                  "vit_tpu/ops/fused_attention_block.py:106", "B/16"),
        "fused_mlp_bwd": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:177",
                          "B/16"),
        "fused_attention_block_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                      "vit_tpu/ops/fused_attention_block.py:169", "B/16"),
        "fused_attention_block_bias": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                       "vit_tpu/ops/fused_attention_block.py:515", "lsa"),
        "fused_attention_block_bias_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                           "vit_tpu/ops/fused_attention_block.py:545", "lsa"),
        "flash_attention": ("vit_tpu_torch/csrc/flash_attention.cu",
                            "vit_tpu/ops/flash_attention.py:51, "
                            "vit_tpu/ops/flash_attention_v2.py:38", FLASH_SHAPES[0][0]),
        "flash_backward": ("vit_tpu_torch/csrc/flash_attention.cu",
                           "vit_tpu/ops/flash_backward.py:41, :72", FLASH_SHAPES[0][0]),
        "fused_cross_attention": ("vit_tpu_torch/csrc/fused_cross_attention.cu",
                                  "vit_tpu/ops/fused_cross_attention.py:71", SSA_SHAPES[0][0]),
        "fused_cross_attention_bwd": ("vit_tpu_torch/csrc/fused_cross_attention.cu",
                                      "vit_tpu/ops/fused_cross_attention.py:115",
                                      SSA_SHAPES[0][0]),
        "flash_attention_packed": ("vit_tpu_torch/csrc/flash_attention.cu",
                                   "vit_tpu/ops/flash_attention_packed.py:58",
                                   PACKED_SHAPES[0][0]),
        "short_attention": ("vit_tpu_torch/csrc/short_attention.cu",
                            "vit_tpu/ops/short_attention.py:82", SHORT_SHAPES[0][0]),
        "short_attention_bwd": ("vit_tpu_torch/csrc/short_attention.cu",
                                "vit_tpu/ops/short_attention.py:97", SHORT_SHAPES[0][0]),
        "ln_gemm": ("vit_tpu_torch/csrc/fused_hybrid.cu", "vit_tpu/ops/fused_hybrid.py:105",
                    "B/32"),
        "ln_gemm_bwd": ("vit_tpu_torch/csrc/fused_hybrid.cu", "vit_tpu/ops/fused_hybrid.py:125",
                        "B/32"),
        "attention_nb": ("vit_tpu_torch/csrc/short_attention.cu",
                         "vit_tpu/ops/fused_hybrid.py:317", "B/32"),
        "attention_nb_bwd": ("vit_tpu_torch/csrc/short_attention.cu",
                             "vit_tpu/ops/fused_hybrid.py:345", "B/32"),
        "proj_mlp": ("vit_tpu_torch/csrc/fused_hybrid.cu", "vit_tpu/ops/fused_hybrid.py:504",
                     "B/32"),
        "proj_mlp_bwd": ("vit_tpu_torch/csrc/fused_hybrid.cu",
                         "vit_tpu/ops/fused_hybrid.py:531", "B/32"),
    }
    launches = {name: sum(path[name] for path in by_path.values()) for name in counters}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name}: not launched on any main path")

    log("earlier designs' kernel ms, constants cited from PERF.md (not measured in this run): "
        + json.dumps(EARLIER_DESIGN_MS))
    log(json.dumps({"kernels": [kernel_entry(results, by_path, name, *where)
                                for name, where in sources.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
