"""Input pipeline: host to device prefetch (port of ``vit_tpu/utils/data.py``).

Batches stream from any host iterator, each process loads its own slice of
the global batch (:func:`process_local_batch_size`), and :func:`prefetch`
keeps a few batches in flight on the card: their copies run on a side CUDA
stream from pinned host memory while the previous step computes.

    batches = prefetch(ThreadedLoader(make_batch, steps),
                       device_put=functools.partial(shard_batch, mesh=mesh))
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_local_batch_size(global_batch_size: int) -> int:
    """Each process's share of the global batch: ``global // world``, the
    whole batch in one process; ``ValueError`` where it does not divide."""
    count = _world()
    if global_batch_size % count:
        raise ValueError(f"global batch {global_batch_size} must divide evenly over "
                         f"{count} processes")
    return global_batch_size // count


def _map(fn, batch):
    """``fn`` over the leaves of a nested dict, tuple or list."""
    if isinstance(batch, dict):
        return {k: _map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_map(fn, v) for v in batch)
    return fn(batch)


def _device_of(mesh) -> torch.device:
    if mesh is not None:
        return torch.device(mesh.device_type, torch.cuda.current_device()) \
            if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() \
        else torch.device("cpu")


def shard_batch(batch, mesh=None, axis: str = "data", device=None):
    """Place this process's slice of the batch (a nested dict, tuple or list
    of numpy arrays or CPU tensors) on its device: the card unless
    ``device`` or a CPU mesh says otherwise.  Under data parallelism each
    process feeds its own slice, which is what ``vit_tpu``'s
    ``make_array_from_process_local_data`` assembles; so with or without a
    group the slice goes as it is.  A card's copies go through pinned host
    memory with ``non_blocking=True``, on the current stream."""
    device = torch.device(device) if device is not None else _device_of(mesh)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) if isinstance(x, np.ndarray) \
            else torch.as_tensor(x)
        if device.type != "cuda":
            return t.to(device)
        return t.pin_memory().to(device, non_blocking=True)

    return _map(put, batch)


def prefetch(iterator: Iterator[Any], size: int = 2,
             device_put: Optional[Callable] = None) -> Iterator[Any]:
    """Keep ``size`` device batches in flight ahead of the consumer.

    ``device_put`` maps a host batch to device tensors (e.g.
    ``functools.partial(shard_batch, mesh=mesh)``); without it each leaf goes
    to the card (the CPU without one) with a plain ``.to(device)``.  On the
    card the copies run on a side stream: the consumer's stream waits on
    each batch's event before it gets the batch, and each tensor is marked
    used by that stream (``record_stream``), so the allocator does not reuse
    its memory while the consumer reads it.  A pinned host buffer
    (:func:`shard_batch`'s) goes back to PyTorch's pinned-memory cache only
    after its copy has completed: the cache records an event on the copy's
    stream for every ``non_blocking`` copy out of it."""
    if device_put is None:
        device = _device_of(None)

        def device_put(batch):
            return _map(lambda x: torch.as_tensor(x).to(device), batch)

    side = torch.cuda.Stream() if torch.cuda.is_available() else None
    queue = collections.deque()

    def enqueue(n):
        for _ in range(n):
            try:
                batch = next(iterator)
            except StopIteration:
                return
            if side is None:
                queue.append((device_put(batch), None))
                continue
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                out = device_put(batch)
                done = torch.cuda.Event()
                done.record(side)
            queue.append((out, done))

    enqueue(size)
    while queue:
        out, done = queue.popleft()
        if done is not None:
            consumer = torch.cuda.current_stream()
            consumer.wait_event(done)
            _map(lambda t: t.record_stream(consumer) if isinstance(t, torch.Tensor)
                 and t.is_cuda else None, out)
        yield out
        enqueue(1)


class ThreadedLoader:
    """Background-thread host pipeline: ``make_batch(step) -> batch`` runs
    off the main thread (decode, augment), at most ``queue_size`` batches
    ahead; the batches stream through :func:`prefetch`."""

    def __init__(self, make_batch: Callable[[int], Any], num_steps: int,
                 queue_size: int = 4):
        self._make = make_batch
        self._num = num_steps
        self._q: collections.deque = collections.deque()
        self._sem = threading.Semaphore(0)
        self._cap = threading.Semaphore(queue_size)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        for step in range(self._num):
            self._cap.acquire()
            self._q.append(self._make(step))
            self._sem.release()

    def __iter__(self):
        for _ in range(self._num):
            self._sem.acquire()
            batch = self._q.popleft()
            self._cap.release()
            yield batch
