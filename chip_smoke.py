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
   reference as the plain bf16 path is, and agree with the plain path on 99%
   of the top-1s that the plain path's bf16 noise cannot flip.  Median
   forward times of both paths.
6. entry: the same at ViT-B/32 @256 (dim 1024, depth 6), batch 8.
7. training: ``make_train_step`` over ``ViT(..., compute_dtype=bf16)`` with
   f32 parameters and ``torch.optim.SGD(lr=1e-3)``, at bench.py's config
   (ViT-B/32 @256, dim 1024, depth 6, heads 16, mlp 2048, batch 128, labels
   ``arange(128) % 1000``) and at ViT-B/16 @224, batch 64.  The step-1
   gradients of the kernel path and of the plain bf16 path are held against
   an f32 model of the same weights; then four steps on one batch, each
   launching each of the four kernels ``depth`` times, with finite, falling
   losses; median step times of both paths.
8. profile: ``torch.profiler`` over train steps at both training configs;
   device time and launches per step by kernel group, idle share.

Each main path (serving B/16 and B/32, training B/32 and B/16) runs with every
kernel's launch counter set to 0 just before it and read just after.  The line
before the last is the card as ``nvidia-smi`` names it; before that a JSON line
with each kernel's launches (over the main paths, and per path), error, times
and bound.  The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA
device the script exits non-zero and prints no result.
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
# path does, and must agree on top-1 at least as often as it.  Top-1 against
# the plain bf16 path over all images is printed, not held to a fixed share:
# with random weights the 1000 logits' top-2 margin (median 0.079 at B/16) is
# of the order of the bf16 noise of either path (max 0.04 against f32), and
# the plain bf16 path itself agrees with its f32 version on only 93% of top-1s
# (measured on an H100 80GB HBM3 at a 700 W limit).  It is held to
# TOP1_CONFIDENT over the confident images: those whose f32 top-2 margin is
# above twice the plain bf16 path's largest logit error, which that path's
# noise cannot flip.
MAX_ERR_VS_PLAIN_BF16 = 2.0
TOP1_CONFIDENT = 0.99
# Training: at step 1, each parameter's gradient on the kernel path may be at
# most this many times as far (relative L2) from the f32 model's as the plain
# bf16 path's is; the two paths' first losses agree within LOSS_REL_TOL.
MAX_GRAD_ERR_VS_PLAIN_BF16 = 2.0
LOSS_REL_TOL = 1e-2
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


def bound(flops, nbytes):
    """The least time in ms the card could take: the larger of the FLOPs at
    the bf16 peak and the bytes at the memory rate; and which bounds it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def block_bounds(b, n, d, heads, dim_head, hidden):
    """Bounds of the four kernels at one block shape (bf16 activations and
    weights, f32 parameter-gradient sums): FLOPs of the TPU kernels' own
    work; each input read once and each output written once."""
    rows, inner = b * n, heads * dim_head
    attn = 2 * b * heads * n * n * dim_head  # one n x n x dim_head product
    act = rows * d * 2  # one (rows, d) bf16 tensor
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
                                       2 * act + 8 * d * inner + 6 * d),
        # dy, x, qkv, γ, Wqkv, Wo -> dx, dqkv and f32 dγ, dβ, dbo
        "fused_attention_block_bwd": bound(8 * rows * d * inner + 5 * attn,
                                           3 * act + 2 * rows * 3 * inner * 2
                                           + 8 * d * inner + 2 * d + 12 * d),
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


def serving_phase(torch, tag, cfg, batch, requests, seed, smi, counters):
    """Serve ``requests`` batches; returns each kernel's launches over them."""
    from vit_tpu_torch import ViT, cast_params
    from vit_tpu_torch.ops.fused_attention_block import fused_attention_block
    from vit_tpu_torch.ops.fused_mlp import fused_mlp

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = cast_params(ViT(**cfg, device=dev, generator=g), torch.bfloat16).eval()
    plain = ViT(**cfg, fused_attention="never", fused_mlp="never", device=dev,
                dtype=torch.bfloat16).eval()
    plain.load_state_dict(model.state_dict())
    size = cfg["image_size"]
    images = [torch.randn(batch, size, size, 3, generator=g, device=dev)
              for _ in range(requests)]
    depth = cfg["depth"]

    with torch.inference_mode():
        # The main path's run: counters from 0, read right after.
        for c in counters.values():
            c.launches = 0
        outs = []
        for i, img in enumerate(images):
            out = model(img)
            if (fused_attention_block.launches, fused_mlp.launches) != \
                    ((i + 1) * depth, (i + 1) * depth):
                raise AssertionError(
                    f"{tag}: forward {i} launched attention/mlp kernels "
                    f"{fused_attention_block.launches}/{fused_mlp.launches} times, "
                    f"expected {(i + 1) * depth} each")
            outs.append(out)
        torch.cuda.synchronize()
        launches = {name: c.launches for name, c in counters.items()}
        if launches["fused_mlp_bwd"] or launches["fused_attention_block_bwd"]:
            raise AssertionError(f"{tag}: serving launched a backward kernel: {launches}")
        refs = [plain(img) for img in images]
        f32 = ViT(**cfg, fused_attention="never", fused_mlp="never", device=dev,
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
        f"{tuple(outs[0].shape)} finite; kernel launches per forward = depth "
        f"{depth}; max|kernel-plain|={err:.6g} tol={tol:.6g} (1e-1*max|ref|); "
        f"vs f32 reference max|kernel-f32|={err_k:.6g} max|plain-f32|={err_p:.6g} "
        f"(kernel <= {MAX_ERR_VS_PLAIN_BF16}x plain); top-1 agreement "
        f"kernel/plain={top1_kp:.4f} kernel/f32={top1_kf:.4f} plain/f32={top1_pf:.4f} "
        f"(kernel/f32 >= plain/f32); median top-2 margin of the f32 logits "
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
    if top1_kf < top1_pf:
        raise AssertionError(f"{tag}: top-1 agreement with the f32 reference "
                             f"{top1_kf} < the plain bf16 path's {top1_pf}")
    if not (n_confident and top1_conf >= TOP1_CONFIDENT):
        raise AssertionError(f"{tag}: kernel/plain top-1 agreement {top1_conf} over "
                             f"{n_confident} confident images, need {TOP1_CONFIDENT}")
    return launches


def rel_l2(torch, a, ref):
    return (torch.linalg.vector_norm((a - ref).float())
            / torch.linalg.vector_norm(ref.float()).clamp_min(1e-30)).item()


def training_phase(torch, tag, cfg, batch, seed, smi, counters):
    """Train ``ViT(..., compute_dtype=bf16)`` (f32 parameters) with SGD on one
    fixed batch; hold its step-1 gradients and its loss against the plain
    bf16 path and an f32 model of the same weights; count the kernels'
    launches over the steps; time a step on both paths."""
    from vit_tpu_torch import ViT
    from vit_tpu_torch.parallel.train import cross_entropy_loss, make_train_step

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    model = ViT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    plain = ViT(**cfg, compute_dtype=torch.bfloat16, fused_attention="never",
                fused_mlp="never")
    f32 = ViT(**cfg, fused_attention="never", fused_mlp="never")
    for twin in (plain, f32):
        twin.load_state_dict(model.state_dict())
    size, depth = cfg["image_size"], cfg["depth"]
    images = torch.randn(batch, size, size, 3, generator=g, device=dev)
    labels = torch.arange(batch, device=dev) % cfg["num_classes"]
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise AssertionError(f"{tag}: parameters are not f32")

    # Step-1 gradients of the three models on the same weights.
    grads, first = {}, {}
    for name, m in (("kernels", model), ("plain", plain), ("f32", f32)):
        m.train().zero_grad(set_to_none=True)
        loss = cross_entropy_loss(m(images), labels)
        loss.backward()
        first[name] = loss.item()
        grads[name] = {k: p.grad.detach().clone() for k, p in m.named_parameters()}
        m.zero_grad(set_to_none=True)
    del f32
    if any(v.dtype != torch.float32 for v in grads["kernels"].values()):
        raise AssertionError(f"{tag}: gradients are not f32")
    worst_ratio, worst_name, misses = 0.0, "", []
    err_k, err_p = {}, {}
    for k, ref in grads["f32"].items():
        err_k[k], err_p[k] = rel_l2(torch, grads["kernels"][k], ref), rel_l2(
            torch, grads["plain"][k], ref)
        ratio = err_k[k] / max(err_p[k], 1e-30)
        if ratio > worst_ratio:
            worst_ratio, worst_name = ratio, k
        if not err_k[k] <= MAX_GRAD_ERR_VS_PLAIN_BF16 * err_p[k]:
            misses.append(f"{k}: {err_k[k]:.4g} vs plain {err_p[k]:.4g}")
    cat = {n: torch.cat([v.flatten() for v in grads[n].values()]) for n in grads}
    all_k, all_p = rel_l2(torch, cat["kernels"], cat["f32"]), rel_l2(torch, cat["plain"],
                                                                      cat["f32"])
    del grads, cat
    loss_rel = abs(first["kernels"] - first["plain"]) / abs(first["plain"])

    # The main path: counters from 0, TRAIN_STEPS steps, read right after.
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    for c in counters.values():
        c.launches = 0
    losses = []
    for i in range(TRAIN_STEPS):
        losses.append(step(images, labels)["loss"].item())
        got = [c.launches for c in counters.values()]
        if got != [(i + 1) * depth] * len(counters):
            raise AssertionError(f"{tag}: step {i} launched the kernels {got} times, "
                                 f"expected {(i + 1) * depth} each")
    launches = {name: c.launches for name, c in counters.items()}
    plain_step = make_train_step(plain, torch.optim.SGD(plain.parameters(), lr=1e-3))
    ms = interleaved_medians(torch, {"kernels": lambda: step(images, labels),
                                     "plain": lambda: plain_step(images, labels)},
                             rounds=3, calls=3)
    log(f"training {tag}: batch {batch}, f32 params, bf16 compute, SGD(1e-3); step-1 loss "
        f"kernels={first['kernels']:.6f} plain={first['plain']:.6f} f32={first['f32']:.6f} "
        f"(kernels/plain within {LOSS_REL_TOL} relative: {loss_rel:.3g}); step-1 gradients, "
        f"relative L2 error against the f32 model over all parameters: kernels={all_k:.4g} "
        f"plain={all_p:.4g}; worst per-tensor ratio kernels/plain={worst_ratio:.3f} "
        f"({worst_name}; <= {MAX_GRAD_ERR_VS_PLAIN_BF16}); losses over {TRAIN_STEPS} steps "
        f"{[round(v, 6) for v in losses]}; launches per step = depth {depth} for each of "
        f"{list(launches)}; median step ms kernels={ms['kernels']:.3f} "
        f"plain={ms['plain']:.3f} ({batch / ms['kernels'] * 1e3:.1f} vs "
        f"{batch / ms['plain'] * 1e3:.1f} img/s) on {smi}")
    if misses:
        raise AssertionError(f"{tag}: kernel-path gradients beyond "
                             f"{MAX_GRAD_ERR_VS_PLAIN_BF16}x the plain path's error: {misses}")
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
                "ln_bwd_rows_kernel", "ln_bwd_cols_kernel", "layernorm_kernel",
                "colsum_kernel"):
        if own in name:
            return own
    if re.search(r"gemm|xmma|cutlass|sm90_|nvjet", name, re.I):
        return "cuBLAS GEMM (dW, patch embedding, head)"
    if "multi_tensor_apply" in name or "foreach" in name.lower():
        return "optimizer (foreach)"
    return "other PyTorch kernels (casts, embedding, loss, reductions)"


def profile_phase(torch, tag, cfg, batch, seed, smi):
    """Where a train step's device time goes: ``torch.profiler`` over a few
    steps of the training path.  Prints the wall time per step (host clock
    around synchronised steps, profiler off and on), the device's busy time
    per step (the sum of its kernel times: one stream, so kernels do not
    overlap), the idle share against either wall time, and the kernels
    grouped by what they do, with their time and launches per step.  A first
    one-step profile, thrown away, takes the profiler's start-up out of the
    timed one."""
    from torch.profiler import ProfilerActivity, profile

    from vit_tpu_torch import ViT
    from vit_tpu_torch.parallel.train import make_train_step

    g = torch.Generator(device="cuda").manual_seed(seed)
    model = ViT(**cfg, compute_dtype=torch.bfloat16, generator=g)
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

    from vit_tpu_torch.ops.fused_attention_block import (
        fused_attention_block, fused_attention_block_backward,
    )
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_backward

    results = {}
    kernel_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
    kernel_phase(torch, "B/32-entry", 8, 65, 1024, 16, 64, 2048, results)
    backward_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
    backward_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results)

    # The main paths, each with the counters from 0 just before it and read
    # just after.
    counters = {"fused_attention_block": fused_attention_block, "fused_mlp": fused_mlp,
                "fused_attention_block_bwd": fused_attention_block_backward,
                "fused_mlp_bwd": fused_mlp_backward}
    by_path = {
        "serving B/16": serving_phase(torch, "ViT-B/16@224 bf16", B16, 64, 3, 0, smi,
                                      counters),
        "serving B/32": serving_phase(torch, "ViT-B/32@256 bf16 (entry)", ENTRY, 8, 3, 1,
                                      smi, counters),
        "training B/32": training_phase(torch, "ViT-B/32@256 (bench.py)", ENTRY, 128, 2,
                                        smi, counters),
        "training B/16": training_phase(torch, "ViT-B/16@224", B16, 64, 3, smi, counters),
    }
    profile_phase(torch, "ViT-B/32@256 (bench.py)", ENTRY, 128, 0, smi)
    profile_phase(torch, "ViT-B/16@224", B16, 64, 0, smi)

    sources = {
        "fused_mlp": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:147"),
        "fused_attention_block": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                  "vit_tpu/ops/fused_attention_block.py:106"),
        "fused_mlp_bwd": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:177"),
        "fused_attention_block_bwd": ("vit_tpu_torch/csrc/fused_attention_block.cu",
                                      "vit_tpu/ops/fused_attention_block.py:169"),
    }
    launches = {name: sum(path[name] for path in by_path.values()) for name in counters}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name}: not launched on any main path")

    def entry(name, src, tpu):
        """A kernel's line, with times and bounds at the B/16 shapes; the
        forwards' library call is PyTorch's bf16 modules, the backwards' is
        autograd through them for the kernel's own outputs (with the weight
        gradients beside the kernel plus its dW GEMMs)."""
        r = results[name]["B/16"]
        line = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
                "launches": launches[name],
                "launches_by_path": {path: counts[name] for path, counts in by_path.items()},
                "max_abs_err": max(r["err"], r.get("train_fwd_err", 0.0)),
                "ms": r["kernel"], "plain_ms": r["plain"], "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1]}
        if "library" in r:
            line.update(library_ms=r["library"], whole_ms=r["whole"],
                        library_whole_ms=r["library_whole"])
        else:
            line["library_ms"] = r["modules"]
        return line

    log(json.dumps({"kernels": [entry(name, *where) for name, where in sources.items()]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
