"""Tensor-parallel ranks emulated by threads in one process, for the split
modules' CPU tests (``test_torch_tensor_parallel_dense.py``,
``test_torch_tensor_parallel_rest.py``): an all-reduce behind a barrier
(the ranks' terms summed in rank order, the same bits on every rank), a
module split over t such ranks as ``shard_params`` splits it, and the
comparisons.  Imports no JAX; pytest does not collect it.  A test patches
``vit_tpu_torch.ops.tensor_parallel.all_reduce_sum`` with
``lambda t, group: group.all_reduce(t)`` for the ranks to meet."""

import copy
import threading

import numpy as np
import torch

from vit_tpu_torch.layers import common
from vit_tpu_torch.parallel import sharding


def diff(got, want) -> float:
    """max|got - want| over max(1, max|want|)."""
    got, want = (np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float64)
                 for t in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


def join(pieces, kind):
    """The whole tensor from the ranks' slices (the inverse of
    ``sharding.shard_tensor``)."""
    shape = list(pieces[0].shape)
    shape[1 if kind == sharding.ROW else 0] *= len(pieces)
    full = torch.zeros(shape)
    for r, piece in enumerate(pieces):
        views, dim = sharding._views(full, kind, r, len(pieces))
        for view, part in zip(views, piece.split(views[0].shape[dim], dim)):
            view.copy_(part)
    return full


class Ranks:
    """t ranks as threads: an all-reduce (a sum in rank order, the same bits
    on every rank) behind a barrier, and a count of the calls."""

    def __init__(self, t):
        self.barrier = threading.Barrier(t, timeout=60)
        self.slots, self.calls = [None] * t, 0

    def all_reduce(self, rank, x):
        self.slots[rank] = x.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for s in self.slots[1:]:
            total += s
        self.barrier.wait()
        if rank == 0:
            self.calls += 1
        return x.copy_(total)


class Group:
    """One rank's model group: what ``ModelShard.group`` holds."""

    def __init__(self, ranks, rank):
        self.ranks, self.rank = ranks, rank

    def all_reduce(self, x):
        return self.ranks.all_reduce(self.rank, x)


def split_grads(module, t, grads):
    """``grads(m)`` — ``(outputs, input gradients, {name: parameter
    gradient})`` of a module ``m`` — on ``module`` split over t emulated
    ranks: every rank's outputs and input gradients, each parameter's
    gradient gathered (a cut one joined, a whole one rank 0's), the whole
    ones on which the ranks differ, and the all-reduces run."""
    ranks, kinds, modules = Ranks(t), {}, []
    for r in range(t):
        m = copy.deepcopy(module)
        units, _ = sharding._units(m)
        for u in units:
            sharding._split(u, common.ModelShard(Group(ranks, r), r, t))
            kinds.update({sharding._join(u.path, k): kind for k, kind in u.cuts.items()})
        modules.append(m)
    out, errors = [None] * t, []

    def work(r):
        try:
            out[r] = grads(modules[r])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            ranks.barrier.abort()

    threads = [threading.Thread(target=work, args=(r,)) for r in range(t)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    params, differ = {}, []
    for name in out[0][2]:
        pieces = [o[2][name] for o in out]
        if name in kinds:
            params[name] = join(pieces, kinds[name])
        else:
            params[name] = pieces[0]
            if not all(torch.equal(p, pieces[0]) for p in pieces):
                differ.append(name)
    return [o[0] for o in out], [o[1] for o in out], params, differ, ranks.calls
