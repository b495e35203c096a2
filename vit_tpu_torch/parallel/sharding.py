"""Parameter placements for tensor parallelism (port of
``vit_tpu/parallel/sharding.py``) and the split of the port's attentions
and MLPs over the mesh's ``model`` axis.

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
:func:`shard_params` splits the model in place, one slice a rank, each
split module keeping its rank's heads or hidden units and a
:class:`~vit_tpu_torch.layers.common.ModelShard` (``.shard``), its forward
summing partials over the model group (``vit_tpu_torch/ops/
tensor_parallel.py``; the kernels' split forms on the card).  What it
splits:

- ``layers/common.py``'s ``Attention`` and ``MLP``, inside a ``Transformer``
  (the ViT family) or not (Parallel ViT's branches, the layers of DeepViT,
  the patch merger's ViT, CaiT and CrossViT): ``to_qkv`` cut by heads in
  each of q, k and v (:data:`QKV`), ``to_out``'s columns, ``fc1``'s rows
  and bias, ``fc2``'s columns;
- CaiT's ``TalkingHeadsAttention`` (``to_q`` by rows, ``to_kv`` by rows of
  each half, :data:`KV`; ``to_out``'s columns; ``mix_heads_pre_attn``'s
  rows and ``mix_heads_post_attn``'s columns) and DeepViT's ``ReAttention``
  (``to_qkv`` as ``Attention``'s, ``reattn_weights``' rows, ``to_out``'s
  columns; ``reattn_norm`` whole), their head mixes summed over the model
  group (``ops/tensor_parallel.py``'s ``mix_across_heads``);
- CrossViT's ``CrossAttention`` (as CaiT's, without the mixes);
- Twins-SVT's ``LocalAttention`` and ``GlobalAttention`` (``to_q`` by rows,
  ``to_kv`` by rows of each half, :data:`KV`; ``to_out``'s columns) and its
  conv-MLPs;
- CvT's ``CvTAttention`` (the ``pointwise`` halves of ``to_q`` and ``to_kv``,
  ``to_out``'s columns; the depthwise convolutions and their BatchNorms run
  whole) and its ``mlp_fc1`` / ``mlp_fc2``;
- LeViT's ``LeViTAttention`` (``to_q``, ``to_k``, ``to_v`` by rows with
  their BatchNorms' channels, ``pos_bias`` by heads, ``to_out``'s columns;
  ``to_out_bn`` whole) and ``LeViTMLP``;
- MobileViT's ``MobileViTAttention`` (as ``Attention``) and its blocks'
  ``mlp_fc1_{i}`` / ``mlp_fc2_{i}``;
- the small-dataset ViT's ``LSA`` (as ``Attention``, its temperature
  replicated and summed over the model group) and its layers' ``MLP``;
- CrossFormer's ``CrossFormerAttention`` (as ``Attention``; its
  ``DynamicPositionBias`` whole) and ``CrossFormerMLP``;
- RegionViT's ``RegionAttention`` (as ``Attention``), each stage's
  ``local_rel_pos_bias`` table by heads (its columns) and ``RegionMLP``;
- NesT's ``NesTAttention`` (as ``Attention``) and its transformers'
  ``mlp_fc1_{i}`` / ``mlp_fc2_{i}``;
- ATS-ViT's ``ATSAttention`` (as ``Attention``; the token sampling's score
  sum over the model group, so every rank keeps one token set) and CCT's
  ``CCTAttention`` (``to_qkv`` as ``Attention``'s, ``proj``'s columns; its
  ``linear1`` / ``linear2`` whole, as the rule table leaves them);
- ScalableViT's ``ScalableSelfAttention`` (``to_q``, ``to_k``, ``to_v`` by
  rows, ``to_out``'s columns), its ``InteractiveWindowedSelfAttention``
  (``to_q`` and ``to_k`` by rows, the ``local_interactive_module`` by output
  channels, ``to_out``'s columns; ``to_v`` whole) and its ``ConvMLP`` s;
  T2T-ViT's encoder as a ``Transformer``'s.

These modules declare their cuts themselves (``tp_cuts``, beside
``shard``); a ``Transformer``'s layers take :data:`_TRANSFORMER_CUTS`.
Their dropout, split or whole, draws from the model forward's
``generator``, one seed on every rank of a model group, where the model is
split: an active dropout without one raises.

LeViT's ``pos_bias`` columns and its q, k and v BatchNorms' channels
(scale, bias and running statistics), RegionViT's ``local_rel_pos_bias``
columns, CaiT's two head mixes, DeepViT's ``reattn_weights``, CCT's
``proj``, ScalableViT's ``to_k`` and IWSA's ``local_interactive_module`` are
split with their heads, beyond the rule table, which replicates them in
``vit_tpu``: each head reads only its own rows or columns, and each output
channel of the local module all of v, so the numbers are the same.  The
other way, CrossFormer's ``DynamicPositionBias`` stays whole where the rule
table matches its ``fc1`` and ``fc2`` by name (GSPMD shards them around a
LayerNorm over the split width, no Megatron pair), and so does IWSA's
``to_v``, whose output the dense 3x3 local module reads whole: whole, each
reaches every rank's heads through ``copy_to_model_parallel``, with the same
numbers.  The plan lists such parameters under ``replicated``.

A unit that cannot split runs whole on every rank: an attention whose heads
the axis does not divide (CvT-13's stages 1-2 at tp 2, a three-head LeViT
stage, NesT@224's hierarchy 1, a two-head one at tp 4, CCT-14's six heads at
tp 4), an ``Attention`` without an output projection (one head, ``dim_head
== dim``: T2T-ViT's token transformers) and an MLP whose hidden width does
not split (in multiples of 8 where the fused MLP may run: T2T-ViT's 147 and
1323).  Its parameters stay unsplit, it needs no collective (its ``shard``
is ``layers.common.WHOLE``), and the plan lists it under ``whole``.
``vit_tpu`` splits such a layer inside a head (or places it whole where a
width does not divide) and GSPMD sums the partials: the same numbers.  The
plan's ``kinds`` name every split parameter and buffer with its cut
(:data:`COLUMN`, :data:`ROW`, :data:`QKV`, :data:`KV`), so a checkpoint
gathers them whole.  What still raises, ``NotImplementedError`` naming the
module, is the hybrid tier and any parameter the rule table would shard
that no module of the port holds: nothing falls through to replication.

    mesh = make_mesh((dp, tp))
    shard_params(mesh, model)           # in place, before the optimizer is built
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3), mesh=mesh)
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import torch
from torch import nn

from vit_tpu_torch.layers.common import (
    COLUMN, KV, MLP, MLP_CUTS, QKV, ROW, WHOLE, Attention, ModelShard, Transformer,
)
from vit_tpu_torch.ops.tensor_parallel import all_reduce_sum
from vit_tpu_torch.parallel.mesh import MODEL_AXIS, model_group, model_rank, model_size

_COLUMN = ("to_qkv", "to_q", "to_kv", "to_v", "fc1")
_ROW = ("to_out", "fc2")
_INDEX_SUFFIX = re.compile(r"(_\d+)+$")
_PACKED = {QKV: 3, KV: 2}


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
    return _over_axes(mesh, param_specs(model))


def plan_shardings(mesh, model: nn.Module) -> dict:
    """:func:`param_shardings` of :func:`plan_specs`: every parameter's and
    buffer's placements over ``mesh``'s axes as ``model`` lies (a split
    model's by its plan, the BatchNorm buffers it splits included)."""
    return _over_axes(mesh, plan_specs(model))


def _over_axes(mesh, specs: dict) -> dict:
    from torch.distributed.tensor import Replicate

    names = mesh.mesh_dim_names if mesh is not None else ("",)
    return {name: tuple(spec if axis == MODEL_AXIS else Replicate() for axis in names)
            for name, spec in specs.items()}


def _views(full: torch.Tensor, kind: str, rank: int, size: int) -> tuple[list, int]:
    """The views of ``full`` that make up rank ``rank``'s slice, in order, and
    the dimension they are joined along."""
    if kind == ROW:
        width = full.shape[1] // size
        return [full[:, rank * width:(rank + 1) * width]], 1
    if kind == COLUMN:
        width = full.shape[0] // size
        return [full[rank * width:(rank + 1) * width]], 0
    part = full.shape[0] // _PACKED[kind]
    width = part // size
    return [full[j * part + rank * width:j * part + (rank + 1) * width]
            for j in range(_PACKED[kind])], 0


def shard_tensor(full: torch.Tensor, kind: str, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the whole tensor ``full`` (a copy):
    :data:`COLUMN` rows, :data:`ROW` columns, :data:`QKV` / :data:`KV` rows
    of each third / half."""
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
    :class:`~vit_tpu_torch.layers.common.ModelShard`, how each split
    parameter and buffer was cut (``{name: COLUMN | ROW | QKV | KV}``), the
    units that run whole on every rank (they cannot split over the axis)
    and, outside those, the parameters the rule table shards that stay whole
    on every rank (CrossFormer's ``DynamicPositionBias``, IWSA's ``to_v``)."""

    mesh: object
    shard: ModelShard
    kinds: dict
    whole: list = field(default_factory=list)
    replicated: list = field(default_factory=list)


def tensor_parallel_plan(model: nn.Module) -> TensorParallelPlan | None:
    """The plan :func:`shard_params` left on ``model``, or None."""
    return getattr(model, "tensor_parallel", None)


def plan_specs(model: nn.Module) -> dict:
    """``{name: placement}`` on the ``model`` axis for every parameter and
    buffer of ``model`` as it lies: a split model's by its plan (``Shard(0)``
    for rows, :data:`QKV` and :data:`KV` cuts, ``Shard(1)`` for columns,
    ``Replicate()`` for the rest, the whole attentions included); an unsplit
    model's parameters by the rule table and its buffers replicated."""
    from torch.distributed.tensor import Replicate, Shard

    plan = tensor_parallel_plan(model)
    if plan is None or plan.shard.size == 1:
        specs = param_specs(model)
        return {**{name: Replicate() for name, _ in model.named_buffers()}, **specs}
    return {name: Shard(1) if plan.kinds.get(name) == ROW else
            Shard(0) if name in plan.kinds else Replicate()
            for name, _ in [*model.named_parameters(), *model.named_buffers()]}


@dataclass
class _Unit:
    """One module the model axis splits: its path, the module, its cuts
    (``{local name: kind}``, parameters and buffers), an attention's heads
    (None for an MLP), whether it sits in a ``Transformer`` stack, and the
    multiple a rank's hidden width must be (8 where the fused MLP runs it)."""

    path: str
    module: nn.Module
    cuts: dict
    heads: int | None = None
    in_stack: bool = False
    multiple: int = 1


_TRANSFORMER_CUTS = {"attn": {"to_qkv.weight": QKV, "to_out.0.weight": ROW}, "mlp": MLP_CUTS}


def _join(*parts) -> str:
    return ".".join(p for p in parts if p)


def _units(model: nn.Module) -> tuple[list, dict]:
    """``(units, transformers)``: every module :func:`shard_params` splits,
    in order, and the ``Transformer`` stacks by name.  A ``Transformer``'s
    layers split by :data:`_TRANSFORMER_CUTS`, and so does an ``Attention``
    or ``MLP`` outside one; any other module that declares ``tp_cuts``
    (``{local name: kind}``) by those, by heads where it has ``heads``, its
    hidden width a multiple of its ``tp_multiple``.  An MLP's hidden width
    is a multiple of 8 a rank, where the fused MLP may run."""
    units, transformers, stacks = [], {}, ()
    for path, m in model.named_modules():
        if path.startswith(stacks):
            continue
        if isinstance(m, Transformer):
            transformers[path] = m
            stacks += (f"{path}." if path else "",)
            for i, layer in enumerate(m.layers):
                prefix = _join(path, "layers", str(i))
                units.append(_Unit(f"{prefix}.attn", layer["attn"], _TRANSFORMER_CUTS["attn"],
                                   layer["attn"].heads, in_stack=True))
                units.append(_Unit(f"{prefix}.mlp", layer["mlp"], _TRANSFORMER_CUTS["mlp"],
                                   multiple=8))
        elif getattr(m, "tp_cuts", None):
            units.append(_Unit(path, m, m.tp_cuts, getattr(m, "heads", None),
                               multiple=getattr(m, "tp_multiple", 1)))
        elif isinstance(m, Attention):
            units.append(_Unit(path, m, _TRANSFORMER_CUTS["attn"], m.heads))
        elif isinstance(m, MLP):
            units.append(_Unit(path, m, _TRANSFORMER_CUTS["mlp"], multiple=8))
    return units, transformers


def _refuse(model, units, transformers) -> None:
    """``NotImplementedError`` naming the first module the rule table would
    shard that no unit covers, or the first stack on the hybrid tier: what
    this port cannot run split."""
    from torch.distributed.tensor import Shard

    covered = tuple(f"{u.path}." for u in units)
    for name, spec in param_specs(model).items():
        if isinstance(spec, Shard) and not name.startswith(covered):
            owner = name.rsplit(".", 1)[0]
            raise NotImplementedError(
                f"shard_params: {owner} ({type(model.get_submodule(owner)).__name__}) is split "
                f"over the '{MODEL_AXIS}' axis by the rule table, and no module of the port "
                f"that runs split or whole over it holds it")
    for tname, t in transformers.items():
        if t.fused_attention == "hybrid":
            raise NotImplementedError(
                f"shard_params: {tname or 'the Transformer'} takes the short-sequence tier "
                f"(fused_attention='hybrid': ln_gemm, attention_nb, proj_mlp), which has no "
                f"split form yet")


def _runs_whole(u: _Unit, size: int) -> bool:
    """Whether ``u`` cannot split over ``size`` ranks and runs whole: an
    ``Attention`` without an output projection (one head, ``dim_head ==
    dim``), an attention whose heads ``size`` does not divide, or a hidden
    width that does not split (into multiples of ``u.multiple``)."""
    if isinstance(u.module, Attention) and not u.module.project_out:
        return True
    if u.heads is not None:
        return u.heads % size != 0
    for name, kind in u.cuts.items():
        if kind == COLUMN and name.endswith("weight"):
            hidden = u.module.get_parameter(name).shape[0]
            if hidden % size or hidden // size % u.multiple:
                return True
    return False


def _replace(module: nn.Module, name: str, kind: str, shard: ModelShard) -> None:
    """Swap the parameter or buffer ``name`` of ``module`` for this rank's
    slice of it."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name) if owner_name else module
    old = getattr(owner, leaf)
    local = shard_tensor(old.detach(), kind, shard.rank, shard.size)
    if isinstance(old, nn.Parameter):
        setattr(owner, leaf, nn.Parameter(local, requires_grad=old.requires_grad))
    else:
        owner.register_buffer(leaf, local)


def _split(u: _Unit, shard: ModelShard) -> None:
    """Cut ``u``'s parameters and buffers and record the shard on the
    module, whose forward reads it."""
    for name, kind in u.cuts.items():
        _replace(u.module, name, kind, shard)
    u.module.shard = shard
    if u.heads is not None:
        u.module.heads //= shard.size
    for m in u.module.modules():  # the nn.Linear widths the repr shows
        if isinstance(m, nn.Linear):
            m.out_features, m.in_features = m.weight.shape


def shard_params(mesh, model: nn.Module) -> nn.Module:
    """Split ``model`` over ``mesh``'s ``model`` axis in place and return it:
    each attention keeps this rank's heads (``heads`` becomes the local
    count) and each MLP its hidden units, as the module docstring lists
    them; each records the
    :class:`~vit_tpu_torch.layers.common.ModelShard`, and ``model`` the
    :class:`TensorParallelPlan` (``model.tensor_parallel``).  A unit that
    cannot split (heads the axis does not divide, no output projection, a
    hidden width that does not split) stays whole (``plan.whole``);
    CrossFormer's position-bias MLPs and IWSA's ``to_v`` stay whole
    (``plan.replicated``).  First the model group's first
    rank's parameters and buffers are broadcast, so the ranks split one
    model.  Call it before the optimizer is built: the split parameters are
    new tensors.

    Raises ``NotImplementedError``, naming the module, on the hybrid tier
    (``fused_attention="hybrid"``) and where the rule table would shard a
    parameter that no module of the port holds.  Without a mesh it returns
    ``model`` as it is; over a ``model`` axis of 1 it splits nothing and
    records the plan."""
    if mesh is None:
        return model
    if tensor_parallel_plan(model) is not None:
        raise ValueError("shard_params: the model is split already")
    size = model_size(mesh)
    shard = ModelShard(model_group(mesh), model_rank(mesh), size)
    kinds, whole, replicated = {}, [], []
    if size > 1:
        from vit_tpu_torch.parallel.train import broadcast_state

        units, transformers = _units(model)
        _refuse(model, units, transformers)
        broadcast_state(model, shard.group)
        with torch.no_grad():
            for u in units:
                if _runs_whole(u, size):
                    u.module.shard = WHOLE  # its dropout draws from the generator
                    whole.append(u.path)
                    continue
                _split(u, shard)
                kinds.update({_join(u.path, name): kind for name, kind in u.cuts.items()})
        replicated = _replicated(model, kinds, whole)
    model.tensor_parallel = TensorParallelPlan(mesh, shard, kinds, whole, replicated)
    return model


def _replicated(model: nn.Module, kinds: dict, whole: list) -> list:
    """The parameters the rule table shards that the plan keeps whole,
    outside the units that run whole."""
    from torch.distributed.tensor import Shard

    skip = tuple(f"{path}." for path in whole)
    return [name for name, spec in param_specs(model).items()
            if isinstance(spec, Shard) and name not in kinds and not name.startswith(skip)]
