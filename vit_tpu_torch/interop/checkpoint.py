"""Checkpoint and resume (port of ``vit_tpu/interop/checkpoint.py``).

``vit_tpu`` writes its train state with orbax.  Here a state is a
:class:`~vit_tpu_torch.parallel.train.TrainState` (the model's
``state_dict``, the optimizer's ``state_dict`` and the step), an
``nn.Module`` (its ``state_dict``) or a nested dict of tensors, written with
``torch.save`` after every tensor is copied to the host, read with
``torch.load(weights_only=True)``.  A write goes to a temporary file that
``os.replace`` then moves into place, so a checkpoint on disk is whole.

    manager = CheckpointManager(directory)
    manager.save(step, train_step.state, wait=False)     # written in the background
    ...
    manager.restore(target=create_train_state(model, optimizer))

An optimizer's state is keyed by parameter index: restore it into an
optimizer built over the same model in the same order.  Under a process
group rank 0 writes, and :meth:`CheckpointManager.wait` and
:meth:`CheckpointManager.restore` meet every rank at a barrier, so that all
of them read the same file.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from vit_tpu_torch.parallel.train import TrainState


def _tree(state) -> Any:
    """What is written of ``state``."""
    if isinstance(state, TrainState):
        return {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "step": int(state.step)}
    if isinstance(state, nn.Module):
        return state.state_dict()
    return state


def _to_host(tree) -> Any:
    """A copy of ``tree`` with every tensor on the host: the snapshot a write
    reads, whatever the train step does to the state meanwhile."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return type(tree)((k, _to_host(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write(path: str, snapshot) -> None:
    tmp = f"{path}.tmp-{os.getpid()}-{threading.get_ident()}"
    torch.save(snapshot, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: Any) -> None:
    """Write ``state`` (a ``TrainState``, a module or a nested dict of
    tensors) to the file ``path``, atomically."""
    _write(os.path.abspath(path), _to_host(_tree(state)))


def _load_into(target, data):
    """Copy ``data`` into the tensors of the nested dict ``target`` in place,
    each on its own device and in its own dtype; other leaves are replaced."""
    for k, v in data.items():
        if isinstance(target.get(k), torch.Tensor):
            with torch.no_grad():
                target[k].copy_(v)
        elif isinstance(target.get(k), dict) and isinstance(v, dict):
            _load_into(target[k], v)
        else:
            target[k] = v
    return target


def restore_checkpoint(path: str, target: Optional[Any] = None) -> Any:
    """Read the checkpoint at ``path``.  Without ``target``, the raw nested
    dict of CPU tensors; with one (a ``TrainState``, a module or a nested
    dict of tensors like the one saved), its contents loaded into it, on its
    own device and in its own dtype, and ``target`` returned."""
    data = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    if target is None:
        return data
    if isinstance(target, TrainState):
        target.model.load_state_dict(data["model"])
        target.optimizer.load_state_dict(data["optimizer"])
        target.step = data["step"]
        return target
    if isinstance(target, nn.Module):
        target.load_state_dict(data)
        return target
    return _load_into(target, data)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


class CheckpointManager:
    """Rolling step-numbered checkpoints in ``directory`` with resume from
    the latest: at most ``max_to_keep`` are kept, the oldest deleted first."""

    _NAME = re.compile(r"^checkpoint_(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        if _rank() == 0:
            os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint_{step}.pt")

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for name in os.listdir(self.directory)
                      if (m := self._NAME.match(name)))

    def _write_and_prune(self, step: int, snapshot) -> None:
        try:
            _write(self._path(step), snapshot)
            for old in self._steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        except BaseException as e:  # raised again by wait()
            self._error = e

    def save(self, step: int, state: Any, wait: bool = True) -> None:
        """Write ``state`` as the checkpoint of ``step``.  The host snapshot
        is taken before it returns; with ``wait=False`` the file is written
        on a background thread, which overlaps the next train steps
        (:meth:`wait`, or the next ``save`` or ``restore``, blocks until it
        is on disk).  Under a process group only rank 0 writes."""
        self._join()
        if _rank() == 0:
            snapshot = _to_host(_tree(state))
            if wait:
                self._write_and_prune(step, snapshot)
            else:
                self._thread = threading.Thread(target=self._write_and_prune,
                                                args=(step, snapshot), daemon=True)
                self._thread.start()
        if wait:
            self.wait()

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def wait(self) -> None:
        """Block until every save is on disk (every rank, under a group)."""
        self._join()
        if dist.is_initialized():
            dist.barrier()

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, target: Any = None) -> Any:
        """The checkpoint of ``step`` (the latest by default), as
        :func:`restore_checkpoint` returns it; ``ValueError`` where there is
        none."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise ValueError(f"no checkpoints in {self.directory}")
        return restore_checkpoint(self._path(step), target)
