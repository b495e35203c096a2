"""Tracing and timing hooks (port of ``vit_tpu/utils/profiling.py``).

:func:`trace` records ``torch.profiler`` over the CPU and CUDA activities
into a Chrome trace under a directory, :func:`named_scope` labels a region
of it, and :func:`op_breakdown` reads the newest trace back as where the
device time went.  :func:`benchmark` and :func:`benchmark_throughput` time
a callable with its device work forced to complete at each boundary.
"""

from __future__ import annotations

import contextlib
import glob
import json
import os
import time
from collections import defaultdict
from typing import Callable

import numpy as np
import torch

named_scope = torch.profiler.record_function


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block: CPU operators and, where there is a card, its
    kernels, written as ``trace_<time>.json`` (Chrome's trace format) under
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{time.time_ns()}.json"))


# The Chrome trace's event categories: the card's kernels, and the CPU's
# operators (what runs the computation where there is no card).
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_CPU_CATEGORIES = ("cpu_op",)


def op_breakdown(logdir: str, top: int = 25) -> list[dict]:
    """Where the device time of the newest trace under ``logdir`` went: rows
    ``{name, occurrences, total_ms, pct}`` sorted by total time, from the
    card's kernel events, or from the CPU's operator events where the trace
    holds none (the CPU is then the device; nested operators count in each
    of their parents too)."""
    paths = sorted(glob.glob(os.path.join(logdir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    with open(paths[-1]) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    picked = [e for e in events if e.get("cat") in _DEVICE_CATEGORIES] \
        or [e for e in events if e.get("cat") in _CPU_CATEGORIES]
    per_op: dict = defaultdict(lambda: [0, 0.0])  # name -> [count, us]
    for e in picked:
        per_op[e["name"]][0] += 1
        per_op[e["name"]][1] += float(e.get("dur", 0.0))
    total = sum(us for _, us in per_op.values())
    rows = [{"name": name, "occurrences": count, "total_ms": us / 1e3,
             "pct": 100.0 * us / max(total, 1e-12)} for name, (count, us) in per_op.items()]
    rows.sort(key=lambda r: -r["total_ms"])
    return rows[:top]


def _force(out):
    """Wait for the device work behind ``out``: synchronise the card where
    there is one (a CPU result is ready when it returns)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out


def benchmark(fn: Callable, *args, iters: int = 30, warmup: int = 5, **kwargs) -> dict:
    """Seconds per call of ``fn``, each call's device work completed before
    the clock stops: ``{mean_s, median_s, min_s, iters}``."""
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    _force(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _force(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {"mean_s": float(times.mean()), "median_s": float(np.median(times)),
            "min_s": float(times.min()), "iters": iters}


def benchmark_throughput(fn: Callable, *args, batch: int, iters: int = 30, warmup: int = 5,
                         **kwargs) -> dict:
    """Amortised throughput: ``iters`` calls enqueued back to back, the
    device synchronised once at the end (a training loop's steps chain, so
    the host's dispatch overlaps the device's work): ``{sec_per_step,
    items_per_sec, iters}``."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _force(None)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    _force(None)
    dt = (time.perf_counter() - t0) / iters
    return {"sec_per_step": dt, "items_per_sec": batch / dt, "iters": iters}
