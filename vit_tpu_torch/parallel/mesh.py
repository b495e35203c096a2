"""Process group and device mesh (port of ``vit_tpu/parallel/mesh.py``).

``vit_tpu`` lays a ``jax.sharding.Mesh`` with named ``data`` / ``model`` axes
over every device and lets XLA insert the collectives.  Here one process
drives one card: :func:`initialize_distributed` joins the process group
(``torch.distributed``; NCCL on the card, gloo when asked for the CPU), and
:func:`make_mesh` lays a ``DeviceMesh`` with the same axis names over the
group's world.  Data parallelism rides the ``data`` axis: the train steps of
:mod:`vit_tpu_torch.parallel.train` take ``mesh=`` and average the gradients
over it.  Tensor parallelism rides the ``model`` axis: the ranks of one model
group (consecutive ranks, ``(data, model)`` in row-major order, as
``vit_tpu``'s mesh lays its devices) each hold a slice of every transformer
block (:func:`vit_tpu_torch.parallel.sharding.shard_params`).

    rank, world = initialize_distributed()          # under torchrun
    mesh = make_mesh()                               # every rank on "data"
    step = make_train_step(model, optimizer, mesh=mesh)

    mesh = make_mesh((world // 2, 2))                # tensor parallel over pairs
    shard_params(mesh, model)                        # before the optimizer
    step = make_train_step(model, torch.optim.SGD(model.parameters(), 1e-3), mesh=mesh)
"""

from __future__ import annotations

import math
import os
from datetime import timedelta
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
# The group's timeout: a rank that fails before a collective leaves the others
# waiting this long, not torch.distributed's 30 minutes.
DEFAULT_TIMEOUT_S = 600.0
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    *,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> tuple[int, int]:
    """Join the process group; returns ``(rank, world_size)``.

    Without arguments it takes the launcher's rendezvous (``torchrun``'s
    ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``); with them,
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` name the group.  As ``vit_tpu``'s, it is a no-op returning
    ``(0, 1)`` for ``num_processes == 1`` and for a bare call outside a
    launcher; a configuration that was given and fails raises.  A group that
    is already up is returned as it is.

    ``backend`` is NCCL unless the caller asks for another (``"gloo"`` for
    ranks on the CPU).  On NCCL each rank takes the card
    ``local_device_ids[0]``, else ``LOCAL_RANK`` (0 without it), as its
    current device before it joins.  ``timeout_s`` bounds every collective.
    """
    if num_processes == 1:
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id,
                                           local_device_ids))
    if not explicit and not all(k in os.environ for k in _LAUNCHER_ENV):
        return 0, 1  # a bare call outside a launcher: one process
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed: NCCL needs a CUDA device; pass "
                               "backend='gloo' for ranks on the CPU")
        local = (local_device_ids[0] if local_device_ids
                 else int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
    kw = dict(backend=backend, timeout=timedelta(seconds=timeout_s))
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            kw.update(world_size=num_processes if num_processes is not None
                      else int(os.environ["WORLD_SIZE"]),
                      rank=process_id if process_id is not None else int(os.environ["RANK"]))
        dist.init_process_group(init_method="env://", **kw)
    else:
        if num_processes is None or process_id is None:
            raise ValueError("initialize_distributed: a coordinator_address needs "
                             "num_processes and process_id")
        address = coordinator_address if "://" in coordinator_address \
            else f"tcp://{coordinator_address}"
        dist.init_process_group(init_method=address, world_size=num_processes,
                                rank=process_id, **kw)
    return dist.get_rank(), dist.get_world_size()


def make_mesh(mesh_shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the process group's world, or None without a
    group (one process, one card).

    Default: every rank on the ``data`` axis, the others of size 1 (pure
    data parallelism); ``(dp, tp)`` lays a ``data`` axis of dp over a
    ``model`` axis of tp (tensor parallelism, ``shard_params``).  A shape
    that does not cover the world raises ``ValueError``, outside a group any
    shape but all ones.  ``device_type`` is ``"cuda"`` unless the caller asks
    for ``"cpu"`` (gloo ranks)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if mesh_shape is None:
        mesh_shape = (world,) + (1,) * (len(axis_names) - 1)
    mesh_shape, axis_names = tuple(mesh_shape), tuple(axis_names)
    if len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh shape {mesh_shape} does not match the axes {axis_names}")
    if math.prod(mesh_shape) != world:
        raise ValueError(f"mesh shape {mesh_shape} does not cover {world} processes")
    if not dist.is_initialized():
        return None
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, mesh_shape, mesh_dim_names=axis_names)


def data_group(mesh):
    """The process group of ``mesh``'s ``data`` axis, or None without a mesh."""
    return None if mesh is None else mesh.get_group(DATA_AXIS)


def data_size(mesh) -> int:
    """The size of ``mesh``'s ``data`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))


def _has_model_axis(mesh) -> bool:
    return mesh is not None and MODEL_AXIS in mesh.mesh_dim_names


def model_group(mesh):
    """The process group of ``mesh``'s ``model`` axis: this rank and the
    others holding the other slices of its blocks; None without one."""
    return mesh.get_group(MODEL_AXIS) if _has_model_axis(mesh) else None


def model_size(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 without one)."""
    return mesh.size(mesh.mesh_dim_names.index(MODEL_AXIS)) if _has_model_axis(mesh) else 1


def model_rank(mesh) -> int:
    """This rank's place on ``mesh``'s ``model`` axis (0 without one)."""
    return mesh.get_local_rank(MODEL_AXIS) if _has_model_axis(mesh) else 0


def batch_sharding(mesh):
    """The batch's placement: its leading axis split over the data axis."""
    from torch.distributed.tensor import Shard

    return (Shard(0),)


def replicated(mesh):
    """A placement that every rank holds whole."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),)
