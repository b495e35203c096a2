"""Parameter placements for tensor parallelism (port of
``vit_tpu/parallel/sharding.py``) and the split of the port's transformer
layers over the mesh's ``model`` axis.

The rule table is ``vit_tpu``'s, on the port's parameter names: the
attention's inner projections and the MLP's hidden width shard over the
``model`` axis (Megatron's column→row pairing: ``to_qkv`` / ``to_q`` /
``to_kv`` / ``to_v`` / ``fc1`` split their output dimension, ``to_out`` /
``fc2`` their input dimension, so one sum a block each way completes them);
everything else replicates.  PyTorch keeps an ``nn.Linear`` weight as ``(out,
in)`` and a convolution's as ``(out, in, kh, kw)``, so a column split is
``Shard(0)`` and a row split ``Shard(1)`` where Flax's ``(in, out)`` and
``(kh, kw, in, out)`` kernels shard their last or second-to-last axis; a
column-split bias is ``Shard(0)``.  CvT-style separable projections take
their parent's rule on the ``pointwise`` half, and a ``depthwise`` half
replicates (its grouped kernel has no contraction to split).
:func:`param_specs` gives each parameter's placement on the ``model`` axis
(``torch.distributed.tensor``'s ``Shard`` / ``Replicate``),
:func:`param_shardings` its placements over every axis of a mesh.

In ``vit_tpu`` tensor parallelism is a placement: GSPMD keeps the unsharded
program's numbers and gathers the operands around each Pallas call.  Here
:func:`shard_params` splits the model in place, one slice a rank:
``layers/common.py``'s ``Attention`` and ``MLP`` inside a ``Transformer``
keep their rank's heads and hidden units (:class:`~vit_tpu_torch.layers.
common.ModelShard`), and their blocks run split forms whose partial sums the
ranks add up (``vit_tpu_torch/ops/tensor_parallel.py``).  The packed
``to_qkv``'s ``Shard(0)`` is taken by heads in each of q, k and v, not over
the packed width.  Whatever else the rule table would shard raises
``NotImplementedError`` naming the module; nothing falls through to
replication.

    mesh = make_mesh((dp, tp))
    shard_params(mesh, model)           # in place, before the optimizer is built
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3), mesh=mesh)
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import torch
from torch import nn

from vit_tpu_torch.layers.common import ModelShard, Transformer
from vit_tpu_torch.ops.tensor_parallel import all_reduce_sum
from vit_tpu_torch.parallel.mesh import MODEL_AXIS, model_group, model_rank, model_size

_COLUMN = ("to_qkv", "to_q", "to_kv", "to_v", "fc1")
_ROW = ("to_out", "fc2")
_INDEX_SUFFIX = re.compile(r"(_\d+)+$")

# How shard_params splits a parameter (and a checkpoint gathers it): by rows
# (dim 0), by columns (dim 1), or by rows in each third of a packed q|k|v.
COLUMN, ROW, QKV = "column", "row", "qkv"


def _normalize(name: str) -> str:
    """Module name → rule key: strip the per-layer index suffix and the
    ``mlp_`` prefix (NesT/CvT name their 1×1 conv-MLP halves ``mlp_fc1_3``;
    Twins names its blocks ``ff1_0/fc1``)."""
    name = _INDEX_SUFFIX.sub("", name)
    if name.startswith("mlp_"):
        name = name[4:]
    return name


def _spec_for_name(name: str, param: torch.Tensor):
    """The placement on the ``model`` axis of the parameter ``name``
    (``vit_tpu``'s ``_spec_for_path`` on the port's dotted names; the index
    of an ``nn.Sequential`` or ``nn.ModuleList``, as in ``to_out.0``, is not
    a module name)."""
    from torch.distributed.tensor import Replicate, Shard

    parts = name.split(".")
    leaf, modules = parts[-1], [p for p in parts[:-1] if not p.isdigit()]
    parent = _normalize(modules[-1]) if modules else ""
    grandparent = _normalize(modules[-2]) if len(modules) >= 2 else ""
    if parent == "pointwise" and grandparent in _COLUMN + _ROW:
        parent = grandparent
    elif parent == "depthwise":
        return Replicate()
    if leaf == "weight" and param.dim() in (2, 4):
        if parent in _COLUMN:
            return Shard(0)
        if parent in _ROW:
            return Shard(1)
    if leaf == "bias" and parent in _COLUMN:
        return Shard(0)
    return Replicate()


def param_specs(model: nn.Module) -> dict:
    """``{name: placement}`` for every parameter of ``model``: ``Shard(0)``,
    ``Shard(1)`` or ``Replicate()`` on the ``model`` axis."""
    return {name: _spec_for_name(name, p) for name, p in model.named_parameters()}


def param_shardings(mesh, model: nn.Module) -> dict:
    """``{name: placements}``: each parameter's placement on every axis of
    ``mesh`` in order (``Replicate()`` on all but the ``model`` axis), as
    ``DTensor`` takes them; ``(Replicate(),)`` each without a mesh."""
    from torch.distributed.tensor import Replicate

    names = mesh.mesh_dim_names if mesh is not None else ("",)
    return {name: tuple(spec if axis == MODEL_AXIS else Replicate() for axis in names)
            for name, spec in param_specs(model).items()}


def _views(full: torch.Tensor, kind: str, rank: int, size: int) -> tuple[list, int]:
    """The views of ``full`` that make up rank ``rank``'s slice, in order, and
    the dimension they are joined along."""
    if kind == ROW:
        width = full.shape[1] // size
        return [full[:, rank * width:(rank + 1) * width]], 1
    if kind == COLUMN:
        width = full.shape[0] // size
        return [full[rank * width:(rank + 1) * width]], 0
    third = full.shape[0] // 3
    width = third // size
    return [full[j * third + rank * width:j * third + (rank + 1) * width] for j in range(3)], 0


def shard_tensor(full: torch.Tensor, kind: str, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the whole tensor ``full`` (a copy):
    :data:`COLUMN` rows, :data:`ROW` columns, :data:`QKV` rows of each third."""
    views, dim = _views(full, kind, rank, size)
    return torch.cat(views, dim)


def gather_tensor(local: torch.Tensor, kind: str, shard: ModelShard) -> torch.Tensor:
    """The whole tensor from every rank's slice ``local`` (the inverse of
    :func:`shard_tensor`), on every rank of ``shard.group``: each rank
    writes its slice into zeros and the ranks sum them (an all-reduce, which
    gloo takes for CUDA tensors too)."""
    shape = list(local.shape)
    shape[1 if kind == ROW else 0] *= shard.size
    full = local.new_zeros(shape)
    views, dim = _views(full, kind, shard.rank, shard.size)
    for view, piece in zip(views, local.split(views[0].shape[dim], dim)):
        view.copy_(piece)
    return all_reduce_sum(full, shard.group)


@dataclass
class TensorParallelPlan:
    """What :func:`shard_params` did to a model: the mesh, this rank's
    :class:`~vit_tpu_torch.layers.common.ModelShard` and how each split
    parameter was cut (``{name: COLUMN | ROW | QKV}``)."""

    mesh: object
    shard: ModelShard
    kinds: dict


def tensor_parallel_plan(model: nn.Module) -> TensorParallelPlan | None:
    """The plan :func:`shard_params` left on ``model``, or None."""
    return getattr(model, "tensor_parallel", None)


def _split_layers(model: nn.Module):
    """``(transformers, attentions, mlps)``: the ``Transformer`` stacks of
    ``model`` by name, and each of their layers' ``Attention`` and ``MLP`` by
    the prefix of its parameters."""
    transformers, attentions, mlps = {}, {}, {}
    for tname, t in model.named_modules():
        if isinstance(t, Transformer):
            transformers[tname] = t
            for i, layer in enumerate(t.layers):
                prefix = ".".join(filter(None, (tname, "layers", str(i))))
                attentions[f"{prefix}.attn"] = layer["attn"]
                mlps[f"{prefix}.mlp"] = layer["mlp"]
    return transformers, attentions, mlps


def _refuse(model, size, transformers, attentions, mlps) -> None:
    """``NotImplementedError`` naming the first module the rule table would
    shard that this port cannot run split over ``size`` ranks."""
    from torch.distributed.tensor import Shard

    split = tuple(f"{p}." for p in (*attentions, *mlps))
    for name, spec in param_specs(model).items():
        if isinstance(spec, Shard) and not name.startswith(split):
            owner = name.rsplit(".", 1)[0]
            raise NotImplementedError(
                f"shard_params: {owner} ({type(model.get_submodule(owner)).__name__}) is split "
                f"over the '{MODEL_AXIS}' axis by the rule table, and the port runs split only "
                f"layers/common.py's Attention and MLP inside a Transformer")
    for tname, t in transformers.items():
        if t.fused_attention == "hybrid":
            raise NotImplementedError(
                f"shard_params: {tname or 'the Transformer'} takes the short-sequence tier "
                f"(fused_attention='hybrid': ln_gemm, attention_nb, proj_mlp), which has no "
                f"split form yet")
    for path, attn in attentions.items():
        if not attn.project_out:
            raise NotImplementedError(f"shard_params: {path} has no output projection to "
                                      f"split by rows (heads 1, dim_head == dim)")
        if attn.heads % size:
            raise NotImplementedError(f"shard_params: {path} has {attn.heads} heads, which "
                                      f"{size} ranks do not divide")
    for path, mlp in mlps.items():
        hidden = mlp.fc1.out_features
        if hidden % size or hidden // size % 8:
            raise NotImplementedError(f"shard_params: {path}'s hidden width {hidden} does not "
                                      f"split over {size} ranks into multiples of 8")


def _replace(module: nn.Module, name: str, kind: str, shard: ModelShard) -> None:
    old = getattr(module, name)
    setattr(module, name, nn.Parameter(shard_tensor(old.detach(), kind, shard.rank, shard.size),
                                       requires_grad=old.requires_grad))


def shard_params(mesh, model: nn.Module) -> nn.Module:
    """Split ``model`` over ``mesh``'s ``model`` axis in place and return it:
    every ``Transformer`` layer's ``Attention`` keeps this rank's heads (the
    rows of each of q, k and v in ``to_qkv``, the columns of ``to_out``;
    ``heads`` becomes the local count), its ``MLP`` this rank's hidden units
    (``fc1``'s rows and bias, ``fc2``'s columns); both record the
    :class:`~vit_tpu_torch.layers.common.ModelShard`, and ``model`` the
    :class:`TensorParallelPlan` (``model.tensor_parallel``).  First the
    model group's first rank's parameters and buffers are broadcast, so the
    ranks split one model.  Call it before the optimizer is built: the split
    parameters are new tensors.

    Raises ``NotImplementedError``, naming the module, where the rule table
    would shard a parameter outside those layers (another attention or MLP,
    a convolution), on the hybrid tier (``fused_attention="hybrid"``), on an
    attention without an output projection, where the heads or the hidden
    width (in multiples of 8) do not divide over the axis.  Without a mesh
    it returns ``model`` as it is; over a ``model`` axis of 1 it splits
    nothing and records the plan."""
    if mesh is None:
        return model
    if tensor_parallel_plan(model) is not None:
        raise ValueError("shard_params: the model is split already")
    size = model_size(mesh)
    shard = ModelShard(model_group(mesh), model_rank(mesh), size)
    kinds = {}
    if size > 1:
        from vit_tpu_torch.parallel.train import broadcast_state

        transformers, attentions, mlps = _split_layers(model)
        _refuse(model, size, transformers, attentions, mlps)
        broadcast_state(model, shard.group)
        with torch.no_grad():
            for path, attn in attentions.items():
                _replace(attn.to_qkv, "weight", QKV, shard)
                _replace(attn.to_out[0], "weight", ROW, shard)
                kinds.update({f"{path}.to_qkv.weight": QKV, f"{path}.to_out.0.weight": ROW})
                attn.heads //= size
                attn.to_qkv.out_features //= size
                attn.to_out[0].in_features //= size
                attn.shard = shard
            for path, mlp in mlps.items():
                for name, kind in (("fc1.weight", COLUMN), ("fc1.bias", COLUMN),
                                   ("fc2.weight", ROW)):
                    layer, leaf = name.split(".")
                    _replace(getattr(mlp, layer), leaf, kind, shard)
                    kinds[f"{path}.{name}"] = kind
                mlp.fc1.out_features //= size
                mlp.fc2.in_features //= size
                mlp.shard = shard
    model.tensor_parallel = TensorParallelPlan(mesh, shard, kinds)
    return model
