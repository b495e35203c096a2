#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths once on one CUDA card,
and check them.

    python3 chip_smoke.py          # from the root of a checkout, one GPU

Phases, one line each (any failure raises and exits non-zero):

1. device: ``nvidia-smi`` name and power limit, torch/CUDA versions; TF32 off
   for the plain versions and the f32 references.
2. build: compiles ``vit_tpu_torch/csrc`` with nvcc, one process per source
   (timed).
3. kernels: each forward kernel against its plain PyTorch version at the
   ViT-B/16 @224 shapes (b=64, n=197, d=768, 12 heads of 64, h=3072) and the
   entry shapes (b=8, n=65, d=1024, 16 heads of 64, h=2048), bf16 inputs from
   a seeded generator; times of the kernel, its plain version and the plain
   modules (bf16 through PyTorch's own GEMMs) with CUDA events around runs of
   back-to-back calls.
4. training kernels, at the B/16 training shapes (b=64) and the B/32 ones
   (b=128, n=65), from seeded bf16 inputs and cotangent: each training
   forward (the kernels that keep xn, h and xn, qkv, oattn) against its plain
   version, output by output; then each backward kernel, fed those kept
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
   a random (16, n, n) bias: the serving and the training forward and the
   backward against their plain versions, output by output, dbias for (ii)
   and (iii) under its own bound (:func:`check_dbias`) and twice, bit for
   bit; times of the kernel, the unbiased kernel on the same inputs, the
   plain version and the bf16 modules with ``scaled_dot_product_attention``
   (``attn_mask=bias``; autograd through them for the backward).
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
11. profile: ``torch.profiler`` over train steps at the three training
   configs; device time and launches per step by kernel group, idle share.

Each main path (serving B/16, B/32 and small-dataset, training B/32, B/16 and
small-dataset) runs with every kernel's launch counter set to 0 just before it
and read just after.  The line before the last is the card as ``nvidia-smi``
names it; before that a JSON line with each kernel's launches (over the main
paths, and per path), error, times and bound.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
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
TRAIN_STEPS = 4
# The H100 SXM's dense bf16 tensor-core peak and memory rate (NVIDIA's data
# sheet, at the full 700 W), for each kernel's bound.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def interleaved_medians(torch, fns: dict, rounds: int, calls: int) -> dict:
    """Median device ms per call of each fn: CUDA events around ``calls``
    back-to-back calls, so the host's enqueue overlaps the device; ``rounds``
    rounds taken in turns, so that clock drift hits every fn alike."""
    for fn in fns.values():  # warm-up
        for _ in range(3):
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


def check_dbias(torch, name, out, ref):
    """Hold a kernel's dbias against its plain version's within
    DBIAS_REL_TOL·max|ref|; returns max|out - ref|, raises on a miss."""
    if out.shape != ref.shape or out.dtype != ref.dtype or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"{name} dbias: {tuple(out.shape)} {out.dtype}, expected "
                             f"{tuple(ref.shape)} {ref.dtype}, finite")
    err = (out - ref).abs().max().item()
    tol = DBIAS_REL_TOL * ref.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name} dbias differs from its plain version by {err} > {tol}")
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
    from vit_tpu_torch.layers.common import MLP, Attention, LayerNorm
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

    cases = {
        "fused_mlp": (fused_mlp,
                      lambda: fused_mlp(x, gamma, beta, *mlp_w),
                      lambda: fused_mlp_reference(x, gamma, beta, *mlp_w),
                      lambda: x + mlp(norm(x))),
        "fused_attention_block": (
            fused_attention_block,
            lambda: fused_attention_block(x, gamma, beta, *attn_w, heads, dim_head),
            lambda: fused_attention_block_reference(x, gamma, beta, *attn_w, heads,
                                                    dim_head),
            lambda: x + attn(norm(x))),
    }
    with torch.inference_mode():
        for name, (wrapper, kernel, plain, modules) in cases.items():
            before = wrapper.launches
            out = kernel()
            torch.cuda.synchronize()
            if wrapper.launches != before + 1:
                raise AssertionError(f"{name}: launch counter did not move")
            ref = plain()
            if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
                raise AssertionError(f"{name}: bad output {tuple(out.shape)}")
            err, excess, tol = block_error(torch, out, ref, x)
            ms = interleaved_medians(torch, {"kernel": kernel, "plain": plain,
                                             "modules": modules}, rounds=5, calls=10)
            log(f"kernel {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} "
                f"h={hidden}]: max|kernel-plain|={err:.6g}, beyond one bf16 unit of "
                f"the output {excess:.6g} tol={tol:.6g} (2e-2*max|ref-x|: a few bf16 "
                f"units of the block's own output); ms kernel={ms['kernel']:.4f} "
                f"plain={ms['plain']:.4f} modules={ms['modules']:.4f}")
            if not excess <= tol:
                raise AssertionError(f"{name}: kernel differs from its plain version "
                                     f"by {excess} beyond one output unit > {tol}")
            results.setdefault(name, {})[tag] = dict(
                err=err, **ms, bound=block_bounds(b, n, d, heads, dim_head, hidden)[name])


def backward_phase(torch, tag, b, n, d, heads, dim_head, hidden, results):
    """At a training shape, from seeded bf16 inputs and cotangent: each
    training forward (the kernels that keep the residuals, as under grad)
    against its plain version, output by output; then each backward kernel,
    fed the residuals the forward kernels kept, against its plain backward on
    the same residuals.  Times of the backward kernel, its plain version, the
    kernel with the two weight-gradient GEMMs (the op's whole backward), and
    PyTorch autograd through the plain bf16 modules, once for the kernel's
    own outputs (dx and the γ, β and bias gradients) and once with the weight
    gradients too."""
    from vit_tpu_torch.layers.common import MLP, Attention, LayerNorm
    from vit_tpu_torch.ops import fused_attention_block as fab, fused_mlp as fm
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

    # The training forwards and the residuals they keep.
    fwd = {
        "fused_mlp": (fm._launch_forward(x, gamma, beta, *mlp_w, eps, save_residuals=True),
                      fm.fused_mlp_forward_reference(x, gamma, beta, *mlp_w, eps),
                      "y, xn, h"),
        "fused_attention_block": (
            fab._launch_forward(x, gamma, beta, *attn_w, heads, dim_head, scale, eps),
            fab.fused_attention_block_forward_reference(x, gamma, beta, *attn_w, heads,
                                                        dim_head, scale, eps),
            "y, xn, qkv, oattn"),
    }
    torch.cuda.synchronize()
    for name, (out, ref, outputs) in fwd.items():
        err = check_outputs(torch, f"{name} training forward", out, ref, {0: x})
        log(f"training forward {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} "
            f"h={hidden}]: ({outputs}) each within one bf16 unit plus 2e-2*max|its own "
            f"part| of the plain version; max|kernel-plain|={err:.6g}")
        results.setdefault(name, {}).setdefault(tag, {})["train_fwd_err"] = err
    _, xn_m, h = fwd["fused_mlp"][0]
    _, xn_a, qkv, oattn = fwd["fused_attention_block"][0]

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
                                                  dim_head, scale, eps)

    def attn_whole():
        out = attn_kernel()
        return out, weight_grad(out[1], xn_a), weight_grad(dy, oattn)

    cases = {
        "fused_mlp_bwd": (fm.fused_mlp_backward, mlp_kernel,
                          lambda: fm.fused_mlp_backward_reference(dy, x, h, gamma, w1, w2, eps),
                          mlp_whole, mlp),
        "fused_attention_block_bwd": (
            fab.fused_attention_block_backward, attn_kernel,
            lambda: fab.fused_attention_block_backward_reference(
                dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps),
            attn_whole, attn),
    }
    for name, (wrapper, kernel, plain, whole, module) in cases.items():
        before = wrapper.launches
        out = kernel()
        torch.cuda.synchronize()
        if wrapper.launches != before + 1:
            raise AssertionError(f"{name}: launch counter did not move")
        err = check_outputs(torch, name, out, plain(), {0: dy})
        ms = interleaved_medians(torch, {
            "kernel": kernel, "plain": plain, "whole": whole,
            "library": autograd_through(module, weights=False),
            "library_whole": autograd_through(module, weights=True)}, rounds=5, calls=5)
        limit, by = block_bounds(b, n, d, heads, dim_head, hidden)[name]
        log(f"backward {name} [{tag} b={b} n={n} d={d} heads={heads}x{dim_head} h={hidden}]: "
            f"fed the forward kernel's residuals; max|kernel-plain| over the outputs={err:.6g}, "
            f"each within one unit plus 2e-2*max|its own part|; ms kernel={ms['kernel']:.4f} "
            f"plain={ms['plain']:.4f} autograd through the bf16 modules for the same outputs="
            f"{ms['library']:.4f}; with the weight gradients: kernel+dW GEMMs="
            f"{ms['whole']:.4f} autograd={ms['library_whole']:.4f}; bound={limit:.4f} ({by})")
        results.setdefault(name, {})[tag] = dict(err=err, **ms, bound=(limit, by))


def biased_phase(torch, b, n, d, heads, dim_head, hidden, results):
    """The biased block at the small-dataset ViT's shapes, for LSA's mask
    (scale 1.0, no dbias), a shared and a per-head random bias: serving and
    training forwards, backward (dbias twice, bit for bit) against the plain
    versions; times beside the unbiased kernel on the same inputs and the
    bf16 modules with ``scaled_dot_product_attention``."""
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
            out = fab.fused_attention_block_bias(*args, bias, heads, dim_head, scale, eps)
            torch.cuda.synchronize()
            if fab.fused_attention_block_bias.launches != before + 1:
                raise AssertionError(f"biased forward {kind}: launch counter did not move")
            ref = fab.fused_attention_block_reference(*args, heads, dim_head, scale, eps, bias)
            if not bool(torch.isfinite(out).all()):
                raise AssertionError(f"biased forward {kind}: non-finite output")
            err, excess, tol = block_error(torch, out, ref, x)
            if not excess <= tol:
                raise AssertionError(f"biased forward {kind}: differs from its plain version "
                                     f"by {excess} beyond one output unit > {tol}")
            fwd_ms = interleaved_medians(torch, {
                "kernel": lambda: fab.fused_attention_block_bias(*args, bias, heads, dim_head,
                                                                 scale, eps),
                "unbiased": lambda: fab.fused_attention_block(*args, heads, dim_head, scale, eps),
                "plain": lambda: fab.fused_attention_block_reference(*args, heads, dim_head,
                                                                     scale, eps, bias),
                "library": lambda: modules(mask)}, rounds=5, calls=10)
        train = fab._launch_forward(*args, heads, dim_head, scale, eps, bias)
        train_err = check_outputs(
            torch, f"biased training forward {kind}", train,
            fab.fused_attention_block_forward_reference(*args, heads, dim_head, scale, eps,
                                                        bias), {0: x})
        _, xn, qkv, oattn = train
        bounds = block_bounds(b, n, d, heads, dim_head, hidden, bias.shape[0], want_dbias)
        fwd_bound = bounds["fused_attention_block"]
        bwd_bound = bounds["fused_attention_block_bwd"]
        log(f"biased forward {shape}: serving max|kernel-plain|={err:.6g}, beyond one bf16 "
            f"unit {excess:.6g} tol={tol:.6g}; training forward (y, xn, qkv, oattn) max "
            f"{train_err:.6g}; ms kernel={fwd_ms['kernel']:.4f} unbiased kernel on the same "
            f"inputs={fwd_ms['unbiased']:.4f} plain={fwd_ms['plain']:.4f} bf16 modules with "
            f"SDPA(attn_mask=bias)={fwd_ms['library']:.4f}; bound={fwd_bound[0]:.4f} "
            f"({fwd_bound[1]})")

        def kernel():
            return fab.fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias,
                                                           heads, dim_head, scale, eps,
                                                           need_dbias=want_dbias)

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
        got = kernel()
        torch.cuda.synchronize()
        if fab.fused_attention_block_bias_backward.launches != before + 1:
            raise AssertionError(f"biased backward {kind}: launch counter did not move")
        want = plain()
        bwd_err = check_outputs(torch, f"biased backward {kind}", got[:5], want[:5], {0: dy})
        dbias_err = dbias_max = None
        if want_dbias:
            dbias_err = check_dbias(torch, f"biased backward {kind}", got[5], want[5])
            dbias_max = want[5].abs().max().item()
            if not torch.equal(got[5], kernel()[5]):
                raise AssertionError(f"biased backward {kind}: dbias differs between two runs")
        elif got[5] is not None:
            raise AssertionError(f"biased backward {kind}: dbias computed unasked")
        del want
        bwd_ms = interleaved_medians(torch, {
            "kernel": kernel,
            "unbiased": lambda: fab.fused_attention_block_backward(
                dy, x, qkv, gamma, wqkv, wo, heads, dim_head, scale, eps),
            "plain": plain, "whole": whole, "library": autograd_through(weights=False),
            "library_whole": autograd_through(weights=True)}, rounds=5, calls=5)
        log(f"biased backward {shape}: fed the forward kernel's residuals; max|kernel-plain| "
            f"over (dx, dqkv, dγ, dβ, dbo)={bwd_err:.6g}, each within one unit plus "
            f"2e-2*max|its own part|; dbias "
            + (f"max|kernel-plain|={dbias_err:.6g} of max|ref|={dbias_max:.6g} (<= "
               f"{DBIAS_REL_TOL}*max|ref|), the same bits in two runs" if want_dbias
               else "not asked for, not computed")
            + f"; ms kernel={bwd_ms['kernel']:.4f} unbiased kernel on the same inputs="
            f"{bwd_ms['unbiased']:.4f} plain={bwd_ms['plain']:.4f} autograd through the bf16 "
            f"modules with SDPA for the same outputs={bwd_ms['library']:.4f}; with the weight "
            f"gradients: kernel+dW GEMMs={bwd_ms['whole']:.4f} autograd="
            f"{bwd_ms['library_whole']:.4f}; bound={bwd_bound[0]:.4f} ({bwd_bound[1]})")
        results.setdefault("fused_attention_block_bias", {})[kind] = dict(
            err=max(err, train_err), **fwd_ms, bound=fwd_bound)
        results.setdefault("fused_attention_block_bias_bwd", {})[kind] = dict(
            err=bwd_err, dbias_err=dbias_err, **bwd_ms, bound=bwd_bound)


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


def serving_phase(torch, tag, vit, cfg, batch, requests, seed, smi, counters, per_forward,
                  top1_sign_test=False):
    """Serve ``requests`` batches through the model class ``vit``; each
    forward must launch each kernel ``per_forward[name]`` times (0 if not
    named).  The kernel path must agree with the f32 reference's top-1 at
    least as often as the plain bf16 path does; with ``top1_sign_test``, for
    a model whose plain path keeps more precision than the kernel route
    (the small-dataset ViT's exact f32 LSA softmax), less often only by
    chance (SIGN_TEST_Z).  Returns each kernel's launches over them."""
    from vit_tpu_torch import cast_params

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = cast_params(vit(**cfg, device=dev, generator=g), torch.bfloat16).eval()
    plain = vit(**cfg, fused_attention="never", fused_mlp="never", device=dev,
                dtype=torch.bfloat16).eval()
    plain.load_state_dict(model.state_dict())
    size = cfg["image_size"]
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
        f32 = vit(**cfg, fused_attention="never", fused_mlp="never", device=dev,
                  dtype=torch.float32).eval()
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


def training_models(torch, vit, cfg, batch, seed):
    """The kernel path ``vit(..., compute_dtype=bf16)`` with f32 parameters
    from a seeded initialisation, the plain bf16 path and the f32 model on
    the same weights, and one seeded batch of images and labels."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = vit(**cfg, compute_dtype=torch.bfloat16, generator=g)
    plain = vit(**cfg, compute_dtype=torch.bfloat16, fused_attention="never",
                fused_mlp="never")
    f32 = vit(**cfg, fused_attention="never", fused_mlp="never")
    for twin in (plain, f32):
        twin.load_state_dict(model.state_dict())
    size = cfg["image_size"]
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
    grads, first = {}, {}
    for name, m in zip(("kernels", "plain", "f32"), models):
        m.train().zero_grad(set_to_none=True)
        loss = cross_entropy_loss(m(images), labels)
        loss.backward()
        first[name] = loss.item()
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
               f"{MAX_GRAD_ERR_VS_PLAIN_BF16}); {temperatures}")
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


def training_phase(torch, tag, vit, cfg, batch, seed, smi, counters, per_step):
    """Train ``vit(..., compute_dtype=bf16)`` (f32 parameters) with SGD on one
    fixed batch; hold its step-1 gradients (:func:`step1_gradients`) and its
    loss against the plain bf16 path and an f32 model of the same weights;
    check that each step launches each kernel ``per_step[name]`` times (0 if
    not named); time a step on both paths."""
    from vit_tpu_torch.parallel.train import make_train_step

    model, plain, f32, images, labels = training_models(torch, vit, cfg, batch, seed)
    first, summary = step1_gradients(torch, tag, (model, plain, f32), images, labels)
    del f32
    loss_rel = abs(first["kernels"] - first["plain"]) / abs(first["plain"])

    # The main path: counters from 0, TRAIN_STEPS steps, read right after.
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    for c in counters.values():
        c.launches = 0
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append(step(images, labels)["loss"].item())
        check_launches(tag, f"step {i}", counters, per_step, i + 1)
    launches = {name: c.launches for name, c in counters.items()}
    plain_step = make_train_step(plain, torch.optim.SGD(plain.parameters(), lr=1e-3))
    ms = interleaved_medians(torch, {"kernels": lambda: step(images, labels),
                                     "plain": lambda: plain_step(images, labels)},
                             rounds=3, calls=3)
    log(f"training {tag}: batch {batch}, f32 params, bf16 compute, SGD(1e-3); step-1 loss "
        f"kernels={first['kernels']:.6f} plain={first['plain']:.6f} f32={first['f32']:.6f} "
        f"(kernels/plain within {LOSS_REL_TOL} relative: {loss_rel:.3g}); {summary}losses "
        f"over {TRAIN_STEPS} steps {[round(v, 6) for v in losses]}; launches per step "
        f"{per_step}; median step ms kernels={ms['kernels']:.3f} "
        f"plain={ms['plain']:.3f} ({batch / ms['kernels'] * 1e3:.1f} vs "
        f"{batch / ms['plain'] * 1e3:.1f} img/s) on {smi}")
    if not loss_rel <= LOSS_REL_TOL:
        raise AssertionError(f"{tag}: first losses differ by {loss_rel} relative")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses} are not finite and falling")
    return launches


# csrc/kernels.cuh Epilogue, for the names of the linear_kernel instances.
EPILOGUES = {0: "store (QKV, doattn)", 1: "bias+GELU", 2: "bias+residual (out-proj, fc2)",
             3: "bias+GELU, keeps h (fc1)", 4: "dGELU (dy·W2)", 5: "f32 out (dxn)"}
PROFILE_STEPS = 5  # profiled steps, after 3 of warm-up


def kernel_group(name: str) -> str:
    """A device kernel's group: the port's own kernels by role, the rest by
    kind."""
    m = re.search(r"linear_kernel<[^,]+, (\d+), (\d+)>", name)
    if m:
        return f"linear_kernel {EPILOGUES.get(int(m.group(1)), m.group(1))}"
    for own in ("mha_fwd_kernel", "mha_bwd_dq_kernel", "mha_bwd_dkv_kernel",
                "mha_bwd_dbias_kernel", "ln_bwd_rows_kernel", "ln_bwd_cols_kernel",
                "layernorm_kernel", "colsum_kernel"):
        if own in name:
            return own + (" (bias)" if "true>" in name else "")
    if re.search(r"conv|fprop|dgrad|wgrad", name, re.I):
        return "cuDNN convolutions (SPT)"
    if re.search(r"gemm|xmma|cutlass|sm90_|nvjet", name, re.I):
        return "cuBLAS GEMM (dW, patch embedding, head)"
    if "multi_tensor_apply" in name or "foreach" in name.lower():
        return "optimizer (foreach)"
    return "other PyTorch kernels (casts, embedding, loss, reductions)"


def profile_phase(torch, tag, vit, cfg, batch, seed, smi):
    """Where a train step's device time goes: ``torch.profiler`` over a few
    steps of the training path.  Prints the wall time per step (host clock
    around synchronised steps, profiler off and on), the device's busy time
    per step (the sum of its kernel times: one stream, so kernels do not
    overlap), the idle share against either wall time, and the kernels
    grouped by what they do, with their time and launches per step.  A first
    one-step profile, thrown away, takes the profiler's start-up out of the
    timed one."""
    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch.parallel.train import make_train_step

    g = torch.Generator(device="cuda").manual_seed(seed)
    model = vit(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    images = torch.randn(batch, cfg["image_size"], cfg["image_size"], 3, generator=g,
                         device="cuda")
    labels = torch.arange(batch, device="cuda") % cfg["num_classes"]
    for _ in range(3):
        step(images, labels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        step(images, labels)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        step(images, labels)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
        f"{1 - busy / prof_wall_ms:.3f} against the profiler-on one")
    log("| kernels | ms / step | launches / step |")
    log("|---|---|---|")
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"| {name} | {ms:.3f} | {count:g} |")


def main() -> int:
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
            for line in build_log.splitlines() if "registers" in line]
    spills = sum("0 bytes spill stores" not in line
                 for line in build_log.splitlines() if "spill stores" in line)
    log(f"build: {build_s:.2f} s, {path.name}, {len(regs)} kernels compiled, "
        f"max {max(regs, default=0)} registers, {spills} with spills")

    from vit_tpu_torch import ViT
    from vit_tpu_torch.models import vit_for_small_dataset
    from vit_tpu_torch.ops.fused_attention_block import (
        fused_attention_block, fused_attention_block_backward, fused_attention_block_bias,
        fused_attention_block_bias_backward,
    )
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_backward

    results = {}
    kernel_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
    kernel_phase(torch, "B/32-entry", 8, 65, 1024, 16, 64, 2048, results)
    backward_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
    backward_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results)
    biased_phase(torch, 64, 257, 1024, 16, 64, 2048, results)
    spt_phase(torch, 64, 256, 16, 1024, smi)

    # The main paths, each with the counters from 0 just before it and read
    # just after.
    counters = {"fused_attention_block": fused_attention_block, "fused_mlp": fused_mlp,
                "fused_attention_block_bwd": fused_attention_block_backward,
                "fused_mlp_bwd": fused_mlp_backward,
                "fused_attention_block_bias": fused_attention_block_bias,
                "fused_attention_block_bias_bwd": fused_attention_block_bias_backward}

    def per_layer(cfg, *names):
        return {name: cfg["depth"] for name in names}

    small = vit_for_small_dataset.ViT
    by_path = {
        "serving B/16": serving_phase(
            torch, "ViT-B/16@224 bf16", ViT, B16, 64, 3, 0, smi, counters,
            per_layer(B16, "fused_attention_block", "fused_mlp")),
        "serving B/32": serving_phase(
            torch, "ViT-B/32@256 bf16 (entry)", ViT, ENTRY, 8, 3, 1, smi, counters,
            per_layer(ENTRY, "fused_attention_block", "fused_mlp")),
        "serving small-dataset": serving_phase(
            torch, "small-dataset ViT 256/16 bf16", small, SMALL_DATASET, 64, 3, 4, smi,
            counters, per_layer(SMALL_DATASET, "fused_attention_block_bias", "fused_mlp"),
            top1_sign_test=True),
        "training B/32": training_phase(
            torch, "ViT-B/32@256 (bench.py)", ViT, ENTRY, 128, 2, smi, counters,
            per_layer(ENTRY, "fused_attention_block", "fused_mlp", "fused_attention_block_bwd",
                      "fused_mlp_bwd")),
        "training B/16": training_phase(
            torch, "ViT-B/16@224", ViT, B16, 64, 3, smi, counters,
            per_layer(B16, "fused_attention_block", "fused_mlp", "fused_attention_block_bwd",
                      "fused_mlp_bwd")),
        "training small-dataset": training_phase(
            torch, "small-dataset ViT 256/16", small, SMALL_DATASET, 64, 5, smi, counters,
            per_layer(SMALL_DATASET, "fused_attention_block_bias", "fused_mlp",
                      "fused_attention_block_bias_bwd", "fused_mlp_bwd")),
    }
    gradient_phase(torch, "small-dataset ViT 256/16", small, SMALL_DATASET, 64, 6, smi)
    profile_phase(torch, "ViT-B/32@256 (bench.py)", ViT, ENTRY, 128, 0, smi)
    profile_phase(torch, "ViT-B/16@224", ViT, B16, 64, 0, smi)
    profile_phase(torch, "small-dataset ViT 256/16", small, SMALL_DATASET, 64, 0, smi)

    sources = {
        "fused_mlp": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:147"),
        "fused_attention_block": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                  "vit_tpu/ops/fused_attention_block.py:106"),
        "fused_mlp_bwd": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:177"),
        "fused_attention_block_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                      "vit_tpu/ops/fused_attention_block.py:169"),
        "fused_attention_block_bias": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                       "vit_tpu/ops/fused_attention_block.py:515"),
        "fused_attention_block_bias_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                           "vit_tpu/ops/fused_attention_block.py:545"),
    }
    launches = {name: sum(path[name] for path in by_path.values()) for name in counters}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name}: not launched on any main path")

    def entry(name, src, tpu):
        """A kernel's line, with times and bounds at the B/16 shapes (the
        biased block's at the small-dataset shapes with LSA's bias, the other
        biases under ``by_bias``); the forwards' library call is PyTorch's
        bf16 modules, the backwards' is autograd through them for the
        kernel's own outputs (with the weight gradients beside the kernel plus
        its dW GEMMs)."""
        biased = "bias" in name
        kinds = results[name]
        r = kinds["lsa" if biased else "B/16"]
        line = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name],
                "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
                "max_abs_err": max(max(k.get("err", 0.0), k.get("train_fwd_err", 0.0))
                                   for k in kinds.values()),
                "ms": r["kernel"], "plain_ms": r["plain"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1], "library_ms": r.get("library", r.get("modules"))}
        if "whole" in r:
            line.update(whole_ms=r["whole"], library_whole_ms=r["library_whole"])
        if biased:
            line["shape"] = "b=64 n=257 d=1024 heads=16x64, LSA bias (1, n, n), scale 1"
            line["by_bias"] = {kind: {k: v for k, v in k_r.items() if k != "bound"}
                               | {"bound_ms": k_r["bound"][0]} for kind, k_r in kinds.items()}
        return line

    log(json.dumps({"kernels": [entry(name, *where) for name, where in sources.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
