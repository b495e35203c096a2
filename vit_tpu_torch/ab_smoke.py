"""Parent against change on one card: the block kernels and the end-to-end
steps of two checkouts, timed in turns.

    python3 vit_tpu_torch/ab_smoke.py PARENT_DIR        # from the root of a checkout, one GPU
    python3 vit_tpu_torch/ab_smoke.py PARENT_DIR mha    # the attention block past 512 tokens

PARENT_DIR is an unpacked ``git archive`` of the commit to compare with, in a
directory that ``.gitignore`` lists (for example ``build/parent``).  Four
processes run in turn: PARENT_DIR, this checkout, this checkout, PARENT_DIR.
Each imports its own checkout's ``chip_smoke.py`` and ``vit_tpu_torch``,
builds its own kernels, and runs

- ``chip_smoke``'s block phases, with every check they make in the smoke: the
  fused MLP's and the attention block's serving forwards at ViT-B/16 (batch
  64) and bench.py's B/32 (batch 128), their training forwards and backwards
  at the same shapes, the biased block's forwards and backwards at the
  small-dataset ViT's (LSA's mask, a shared and a per-head bias), the
  cross-attention block's forward and backward at ScalableViT's four SSA
  shapes, and the hybrid layer's ops at B/32 (the control: the same GEMM
  kernel, none of the block kernels);
- the device ms a call (``torch.profiler``'s kernel time) of the fused MLP's
  and the attention block's backwards at ViT-B/16 and B/32 and of
  ``ln_gemm``'s and ``proj_mlp``'s at B/32, on seeded bf16 inputs;
- train steps (SGD, f32 parameters, bf16 compute) of CvT-13 at 224 and 384 px,
  ScalableViT at 256 px, the small-dataset ViT 256/16 and ViT-B/16 at 224 px,
  batch 64, and of ViT-B/32 at 256 px, batch 128, on rows 1-4 and on the
  hybrid tier; the served forwards of CvT-13 at 384 px (batch 64) and of
  ViT-B/32 on rows 1-4 and on the hybrid tier (batch 128): the wall ms per
  step (host clock around back-to-back steps), the host's enqueue ms per
  step (until the step returns) and the device's busy ms per step
  (``torch.profiler``'s kernel time).

With ``mha`` each process runs instead the attention block's mha route (past
512 tokens) and what shares its kernels: the block's serving forward and its
backward (fed the training forward's residuals) at PiT@224's stage 1 (batch
64, 962 tokens, d 256, 16 heads of 64) beside the F.layer_norm + F.linear +
SDPA + F.linear composition, and at ViT-B/16@384's block (batch 16, 577
tokens); the biased block at the small-dataset ViT's at 384 px (577 tokens,
d 1024, a shared and a per-head bias, dbias included); the flash op at
CvT-13@224's stage 1 (the unbiased instances, forward and backward); and the
PiT@224 train step (batch 64).

Prints one line per process, ``AB <label> <card> {json}``, and a last line
with each time's mean per checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

WARMUP, ROUNDS, STEPS = 3, 3, 5  # a timed round is STEPS back-to-back steps


def timed(torch, fn) -> dict:
    """Median wall ms per call over ROUNDS rounds of STEPS back-to-back calls,
    the median host ms until a call of them returns (its enqueue: a call
    whose enqueue is its wall is host-bound), and the device's busy ms per
    call over STEPS profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    walls, enqueues = [], []
    for _ in range(ROUNDS):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            t1 = time.perf_counter()
            fn()
            enqueues.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3 / STEPS)
    with profile(activities=[ProfilerActivity.CUDA]):  # the profiler's start-up, thrown away
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            fn()
        torch.cuda.synchronize()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / STEPS
    return {"wall": statistics.median(walls), "enqueue": statistics.median(enqueues),
            "busy": busy}


def step_times(torch, cs) -> dict:
    """The end-to-end times (:func:`timed`) of one checkout's model classes,
    at ``chip_smoke``'s configurations."""
    from vit_tpu_torch import CvT, ScalableViT, ViT, cast_params
    from vit_tpu_torch.models import vit_for_small_dataset
    from vit_tpu_torch.parallel.train import make_train_step

    dev = torch.device("cuda")
    trains = {
        "train CvT-13@224": (CvT, cs.CVT13, 64, 224),
        "train CvT-13@384": (CvT, cs.CVT13, 64, 384),
        "train ScalableViT@256": (ScalableViT, cs.SCALABLE, 64, cs.SCALABLE_SIZE),
        "train small-dataset ViT 256/16": (vit_for_small_dataset.ViT, cs.SMALL_DATASET, 64, 256),
        "train ViT-B/16@224": (ViT, cs.B16, 64, 224),
        "train ViT-B/32@256 rows 1-4": (ViT, cs.ENTRY, 128, 256),
        "train ViT-B/32@256 hybrid": (cs.hybrid_vit, cs.ENTRY, 128, 256),
    }
    out = {}
    for tag, (vit, cfg, batch, size) in trains.items():
        g = torch.Generator(device=dev).manual_seed(0)
        model = vit(**cfg, compute_dtype=torch.bfloat16, generator=g)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
        images = torch.randn(batch, size, size, 3, generator=g, device=dev)
        labels = torch.arange(batch, device=dev) % cfg["num_classes"]
        out[tag] = timed(torch, lambda: step(images, labels))
        del model, step
        torch.cuda.empty_cache()
    serves = {"serve CvT-13@384": (CvT, cs.CVT13, 64, 384),
              "serve ViT-B/32@256 rows 1-4": (ViT, cs.ENTRY, 128, 256),
              "serve ViT-B/32@256 hybrid": (cs.hybrid_vit, cs.ENTRY, 128, 256)}
    for tag, (vit, cfg, batch, size) in serves.items():
        g = torch.Generator(device=dev).manual_seed(0)
        model = cast_params(vit(**cfg, device=dev, generator=g), torch.bfloat16).eval()
        images = torch.randn(batch, size, size, 3, generator=g, device=dev)
        with torch.inference_mode():
            out[tag] = timed(torch, lambda: model(images))
        del model
        torch.cuda.empty_cache()
    return out


def backward_device(torch) -> dict:
    """Device ms a call of rows 2 and 4's backwards (the fused MLP's, the
    attention block's) at ViT-B/16 and bench.py's B/32 layer, and of rows 12
    and 14's (``ln_gemm``'s, ``proj_mlp``'s) at B/32: the sum of the kernels
    one call launches (``torch.profiler``, over five calls), on seeded bf16
    inputs and the training forwards' residuals."""
    from vit_tpu_torch.ops import fused_attention_block as fab
    from vit_tpu_torch.ops import fused_hybrid as fh
    from vit_tpu_torch.ops import fused_mlp as fm

    dev, eps = torch.device("cuda"), 1e-3
    g = torch.Generator(device=dev).manual_seed(7)

    def rn(*shape, scale=1.0, shift=0.0):
        return (shift + torch.randn(*shape, generator=g, device=dev) * scale).to(torch.bfloat16)

    def device_ms(fn, calls=5):  # the profile opens with spin kernels it may drop
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(1000)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.key) / 1e3 / calls

    out = {}
    for tag, (b, n, d, heads, dh, hidden) in {"B/16": (64, 197, 768, 12, 64, 3072),
                                              "B/32": (128, 65, 1024, 16, 64, 2048)}.items():
        inner = heads * dh
        x, dy = rn(b, n, d), rn(b, n, d, scale=0.1)
        gamma, beta = rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1)
        w1, b1, w2, b2 = (rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1),
                          rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1))
        wqkv, wo, bo = rn(3 * inner, d, scale=d ** -0.5), rn(d, inner, scale=inner ** -0.5), \
            rn(d, scale=0.1)
        _, _, h = fm._launch_forward(x, gamma, beta, w1, b1, w2, b2, eps, save_residuals=True)
        out.setdefault("fused_mlp_bwd", {})[tag] = device_ms(
            lambda: fm.fused_mlp_backward(dy, x, h, gamma, w1, w2, eps))
        _, _, qkv, oattn, lse = fab._launch_forward(x, gamma, beta, wqkv, wo, bo, heads, dh,
                                                    dh ** -0.5, eps, training=True)
        out.setdefault("fused_attention_block_bwd", {})[tag] = device_ms(
            lambda: fab.fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh,
                                                       dh ** -0.5, eps, oattn, lse))
        if tag == "B/32":
            t = b * n
            x2, dz, h2 = x.reshape(t, d), dy.reshape(t, d), h.reshape(t, hidden)
            dqkv = rn(t, 3 * inner, scale=0.1)
            out["ln_gemm_bwd"] = {tag: device_ms(
                lambda: fh.ln_gemm_backward(dqkv, x2, gamma, wqkv, eps))}
            out["proj_mlp_bwd"] = {tag: device_ms(
                lambda: fh.proj_mlp_backward(dz, x2, h2, gamma, wo, w1, w2, eps))}
    return out


def mha_route(torch, cs, smi) -> tuple:
    """The ``mha`` set's kernels and step (module docstring), through the
    checkout's own ``chip_smoke`` phases: ``(results, steps)``."""
    from vit_tpu_torch import PiT
    from vit_tpu_torch.parallel.train import make_train_step

    results = {}
    block = ("fused_attention_block",)
    tag, n, d = cs.PIT_SHAPES[0]
    for phase in (cs.kernel_phase, cs.backward_phase):
        phase(torch, tag, cs.PIT_BATCH, n, d, 16, 64, 2048, results, kernels=block)
    cs.block_library_phase(torch, tag, cs.PIT_BATCH, n, d, 16, 64, results, smi)
    torch.cuda.empty_cache()
    tag, b, n, d, heads, dh, hidden = cs.MHA_SHAPES[0]
    for phase in (cs.kernel_phase, cs.backward_phase):
        phase(torch, tag, b, n, d, heads, dh, hidden, results, kernels=block)
    tag, b, n, d, heads, dh, hidden = cs.MHA_SHAPES[1]
    cs.biased_phase(torch, b, n, d, heads, dh, hidden, results, tag=tag,
                    kinds=("shared", "per-head"))
    torch.cuda.empty_cache()
    cs.FLASH_SHAPES = cs.FLASH_SHAPES[:1]  # CvT-13@224's stage 1
    cs.flash_phase(torch, results, smi)
    torch.cuda.empty_cache()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    model = PiT(**cs.PIT, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    images = torch.randn(cs.PIT_BATCH, 224, 224, 3, generator=g, device=dev)
    labels = torch.arange(cs.PIT_BATCH, device=dev) % cs.PIT["num_classes"]
    steps = {"train PiT@224": timed(torch, lambda: step(images, labels))}
    return results, steps


def child(which: str) -> dict:
    """One checkout's run, in the checkout's own directory (the working
    directory): ``{"card": ..., "kernels": {kernel: {shape: {kernel, plain,
    library or modules, ...} ms}}, "steps": {tag: {wall, busy} ms}}``; with
    ``which`` ``"mha"`` the set of :func:`mha_route`, else the whole one."""
    sys.path[0] = os.getcwd()  # that checkout's chip_smoke and vit_tpu_torch
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    import chip_smoke as cs
    from vit_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load()
    keep = ("kernel", "plain", "library", "modules", "whole", "library_whole", "unbiased",
            "library_ln", "device", "four steps", "split", "sdpa", "sdpa_whole")

    def kept(results):
        return {name: {tag: {k: v for k, v in r.items() if k in keep}
                       for tag, r in rows.items()} for name, rows in results.items()}

    if which == "mha":
        results, steps = mha_route(torch, cs, smi)
        return {"card": smi, "steps": steps, "device": {}, "kernels": kept(results)}
    results = {}
    cs.kernel_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
    cs.kernel_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results)
    cs.backward_phase(torch, "B/16", 64, 197, 768, 12, 64, 3072, results)
    cs.backward_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results)
    cs.biased_phase(torch, 64, 257, 1024, 16, 64, 2048, results)
    cs.cross_attention_phase(torch, results, smi)
    cs.hybrid_phase(torch, "B/32", 128, 65, 1024, 16, 64, 2048, results, smi)
    torch.cuda.empty_cache()
    device = backward_device(torch)
    torch.cuda.empty_cache()
    return {"card": smi, "steps": step_times(torch, cs), "device": device,
            "kernels": kept(results)}


def main(parent: str, which: str = "all") -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for label, tree in (("parent", parent), ("change", here), ("change", here),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", which],
                              cwd=os.path.abspath(tree), capture_output=True, text=True,
                              timeout=900)
        found = [line for line in proc.stdout.splitlines() if line.startswith("AB-JSON ")]
        if proc.returncode != 0 or not found:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"ab_smoke: the {label} run failed (exit {proc.returncode})")
        result = json.loads(found[0][len("AB-JSON "):])
        print("AB", label, result["card"], json.dumps(
            {"kernels": result["kernels"], "steps": result["steps"],
             "device": result["device"]}), flush=True)
        runs.append((label, result))
    means = {}
    for label, result in runs:
        for name, rows in result["kernels"].items():
            for tag, r in rows.items():
                if "kernel" in r:  # a training forward's check has no times
                    means.setdefault(f"{name} at {tag}, kernel", {}).setdefault(
                        label, []).append(r["kernel"])
        for name, rows in result["device"].items():
            for tag, ms in rows.items():
                means.setdefault(f"{name} at {tag}, device", {}).setdefault(label, []).append(ms)
        for tag, r in result["steps"].items():
            for what in ("wall", "enqueue", "busy"):
                means.setdefault(f"{tag}, {what}", {}).setdefault(label, []).append(r[what])
    print("AB means (ms, parent and change): " + json.dumps(
        {key: {label: statistics.fmean(v) for label, v in by.items()}
         for key, by in means.items()}))
    return 0


if __name__ == "__main__":
    if sys.argv[1] == "--child":
        print("AB-JSON " + json.dumps(child(sys.argv[2])), flush=True)
    else:
        sys.exit(main(*sys.argv[1:3]))
