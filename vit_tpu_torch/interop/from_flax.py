"""Flax ``vit_tpu`` variables → the port's ``state_dict`` (the converse
direction of ``vit_tpu/interop/tf_weights.py``), for ``vit_tpu.ViT``,
``vit_tpu.models.vit_for_small_dataset.ViT``, ``vit_tpu.models.cvt.CvT``,
``vit_tpu.models.scalable_vit.ScalableViT``,
``vit_tpu.models.efficient.ViT``, ``vit_tpu.models.t2t.T2TViT``,
``vit_tpu.models.twins_svt.TwinsSVT``,
``vit_tpu.models.crossformer.CrossFormer``,
``vit_tpu.models.regionvit.RegionViT``, ``vit_tpu.models.nest.NesT``,
``vit_tpu.models.pit.PiT``, ``vit_tpu.models.levit.LeViT``,
``vit_tpu.models.mobile_vit.MobileViT``, ``vit_tpu.models.deepvit.DeepViT``,
``vit_tpu.models.vit_with_patch_merger.ViT`` (and ``PatchMerger``),
``vit_tpu.models.cross_vit.CrossViT``, ``vit_tpu.models.cait.CaiT``,
``vit_tpu.models.parallel_vit.ViT``, ``vit_tpu.models.ats_vit.ViT``,
``vit_tpu.models.cct.CCT``, the layers of ``vit_tpu.layers.common``, the
objectives (``MAE``, ``SimMIM``, ``MPP``, ``DistillWrapper``) and the
``Distillable*`` students (``DistillableT2TViT`` included).

The tree holds NumPy arrays (``jax.tree.map(np.asarray, variables)``), so no
JAX is imported here.  Leaves:
- Dense kernels ``(in, out)`` become ``weight = kernel.T``; Conv kernels
  (HWIO, ``(kh, kw, in, out)``, a depthwise ``GroupedConv``'s ``(kh, kw, 1,
  C)`` included) become OIHW ``weight``s;
- LayerNorm and BatchNorm ``scale`` / ``bias`` become ``weight`` / ``bias``;
  ``ChannelLayerNorm``'s ``g`` / ``b`` keep their names as ``(dim,)``
  vectors; BatchNorm's ``batch_stats`` ``mean`` / ``var`` become
  ``running_mean`` / ``running_var``;
- ``cls_token``, ``pos_embedding``, NesT's ``pos_emb`` (one scalar a
  token), LSA's scalar ``temperature``, the objectives' ``mask_token`` and
  ``distillation_token``, DeepViT's ``reattn_weights``, the patch merger's
  ``queries``, CaiT's ``mix_heads_{pre,post}_attn`` and
  ``layerscale_{attn,mlp}_{i}``, CCT's ``positional_emb`` and ``class_emb``
  keep their names and shapes;
  an ``nn.Embed``'s ``embedding`` (MAE's ``decoder_pos_emb``) becomes the
  ``nn.Embedding``'s ``weight``.

Per-layer modules ``{attn_norm,attn,mlp_norm,mlp,mlp_fc1,mlp_fc2}_{i}`` map to
``layers.{i}.…``: under ``transformer`` for the ViT (``transformer/attn_0`` →
``transformer.layers.0.attn``), under each stage's ``s{1,2,3}_transformer``
for CvT, under each ``t2t_transformer_{i}`` for T2T-ViT's token transformers
(``t2t_transformer_0/attn_0`` → ``t2t_transformer_0.layers.0.attn``; their
attention has no ``to_out``), under MAE's ``decoder``, and at the top for the
small-dataset ViT (``attn_0`` → ``layers.0.attn``).  The objectives' trees nest their models' under ``encoder`` (MAE, SimMIM),
``transformer`` (MPP), ``teacher`` and ``student`` (``DistillWrapper``):
``encoder/transformer/attn_0`` → ``encoder.transformer.layers.0.attn``.
ScalableViT's ``{ssa,ff1,iwsa,ff2}_{i}`` and their
``*_norm_{i}`` map to ``layers.{i}.…`` under each ``stage_{s}``
(``stage_0/iwsa_norm_1`` → ``stage_0.layers.1.iwsa_norm``); a stage's ``peg``
and ``norm`` keep their names.  Twins-SVT's
``{local_norm,local_attn,ff1_norm,ff1,global_norm,global_attn,ff2_norm,ff2}_{i}``
map to ``layers.{i}.…`` under each ``s{s}_pre_transformer`` and
``s{s}_transformer`` (``s3_transformer/global_attn_4/to_kv`` →
``s3_transformer.layers.4.global_attn.to_kv``); ``s{s}_embed/proj``,
``s{s}_peg/proj`` and ``head`` keep their names.  CrossFormer's modules sit at
the top and keep their names: ``cel_{s}/conv_{i}``,
``{short,long}_attn_{s}_{i}/{norm,to_qkv,to_out,dpb}`` (the DPB's
``fc{0,1,2}``, ``norm{0,1,2}`` and ``out``), ``{short,long}_ff_{s}_{i}/{norm,fc1,fc2}``
and ``head``.  RegionViT's modules keep their names too:
``local_encoder`` (or ``local_conv{0,1,2}`` and ``local_norm{0,1}``),
``region_encoder``, ``downsample_{s}``, ``peg_{s}``, ``transformer_{s}``
with ``attn_{i}/{norm,to_qkv,to_out}``, ``ff_{i}/{norm,fc1,fc2}`` and
``local_rel_pos_bias/embedding`` (an ``nn.Embed``: ``weight``), then
``head_norm`` and ``head``.  NesT's keep theirs: ``patch_embedding``,
``transformer_{idx}`` with ``pos_emb`` and
``{attn_norm,attn,mlp_norm,mlp_fc1,mlp_fc2}_{i}`` (``transformer_{idx}`` is
not a stack that ``layers.{i}`` holds), ``aggregate_conv_{idx}``,
``aggregate_norm_{idx}``, ``head_norm`` and ``head``.  PiT's keep theirs
too: ``patch_embedding`` (a Dense-shaped ``kernel (k·k·c, dim)``, so
``weight (dim, k·k·c)``), ``cls_token``, ``pos_embedding``, ``transformer_{i}``,
``pool_{i}/{cls_ff,downsample_grouped,downsample_pointwise}``, ``head_norm``
and ``head``; each stage's ``transformer_{i}`` is a ViT encoder, so its
``{attn_norm,attn,mlp_norm,mlp}_{j}`` map to ``transformer_{i}.layers.{j}.…``
(``transformer_1/attn_2/to_qkv`` → ``transformer_1.layers.2.attn.to_qkv``).
A ``transformer_{i}`` is such a stack when it holds those four kinds of
module and nothing else; NesT's (``pos_emb``, ``mlp_fc1_{j}``) and
RegionViT's (``ff_{j}``) do not, and keep their names.  LeViT's and
MobileViT's keep theirs, ``params`` and ``batch_stats`` alike: LeViT's
``conv_embedding_{i}``, ``stage_{i}`` and ``shrink_{i}`` with ``attn_{j}``
(``to_q``, ``to_q_bn`` … ``pos_bias/embedding`` → ``pos_bias.weight``,
``(fs², heads)`` as it is) and ``mlp_{j}``, ``mlp_head`` and
``distill_head``; MobileViT's ``conv1``, ``stem_{i}``, ``trunk_conv_{i}``,
``trunk_attn_{i}`` (whose ``attn_norm_{j}``, ``attn_{j}``, ``mlp_norm_{j}``,
``mlp_fc1_{j}`` and ``mlp_fc2_{j}`` sit under a module that is not a stack,
so no ``layers.{j}``), ``to_logits_conv`` and ``head``.  DeepViT's and the patch
merger's ViT's per-layer modules sit at the top, as the small-dataset ViT's
(``attn_0`` → ``layers.0.attn``; the merger's ``patch_merger`` as it is);
CaiT's ``patch_transformer`` and ``cls_transformer`` are stacks
(``patch_transformer/attn_0/to_q`` → ``patch_transformer.layers.0.attn.to_q``;
their ``layerscale_{attn,mlp}_{i}`` stay leaves of the transformer).
CrossViT's modules keep their names: ``{sm,lg}_image_embedder``,
``{sm,lg}_enc_{r}`` (with ``{attn_norm,attn,mlp_norm,mlp}_{i}`` and ``norm``:
not a stack, so no ``layers.{i}``), ``cross_attend_{r}``, the heads; Parallel
ViT's too: ``{attn_norm,attn,mlp_norm,mlp}_{i}_{j}`` at the top.  ATS-ViT's
``transformer`` is a stack, as the ViT's; CCT's modules keep their names:
``conv_{i}``, ``block_{i}`` (``pre_norm``, ``self_attn/{to_qkv,proj}``,
``norm1``, ``linear1``, ``linear2``), ``norm``, ``attention_pool``, ``fc``.
``to_out`` maps to
``to_out.0`` (the projection before its dropout; LeViT's ``to_out`` is a
one-convolution ``nn.Sequential`` for it).  The small-dataset ViT's ``patch_embedding/norm`` and
``patch_embedding/proj`` keep their names; the proj kernel's rows stay in the
(p1, p2, group, c) order its SPT reads.

Flax creates the parameters of the submodules a model calls only, so an
objective's encoder tree (MAE's, SimMIM's, MPP's) has no ``head`` or
``head_norm``: its state_dict lacks those four keys, and loads into the
port's module with ``strict=False``, exactly those four missing.
"""

from __future__ import annotations

import re

import numpy as np
import torch

# Per-layer modules under a stack (or at the top): the ViTs' and MAE's
# decoder's, and Twins-SVT's (under each s{i}_pre_transformer and
# s{i}_transformer).
_LAYER = re.compile(r"^(attn_norm|attn|mlp_norm|mlp|mlp_fc1|mlp_fc2|local_norm|local_attn|ff1_norm"
                    r"|ff1|global_norm|global_attn|ff2_norm|ff2)_(\d+)$")
# ScalableViT's per-layer modules, under a stage_{s}.
_STAGE_LAYER = re.compile(r"^(ssa_norm|ssa|ff1_norm|ff1|iwsa_norm|iwsa|ff2_norm|ff2)_(\d+)$")
_STAGE = re.compile(r"^stage_\d+$")
# Modules that hold per-layer modules: the encoders, T2T-ViT's token
# transformers, Twins-SVT's stacks and MAE's decoder (the small-dataset
# ViT's sit at the top).
_STACK = re.compile(r"^(transformer|decoder|\w+_transformer|t2t_transformer_\d+)$")
# A stage of PiT: transformer_{i} holding only the ViT encoder's per-layer
# modules (_encoder_stacks).
_NUMBERED = re.compile(r"^transformer_\d+$")
_ENCODER_LAYER = re.compile(r"^(attn_norm|attn|mlp_norm|mlp)_\d+$")
# Leaves that keep their names and shapes: the biases, the tokens and
# embeddings, LSA's temperature, DeepViT's (heads, heads) reattn_weights, the
# patch merger's queries, CaiT's talking-heads mixes and its LayerScales
# (parameters of the transformer itself, named by layer), CCT's learned
# positions and cls token.
_KEPT = re.compile(r"^(bias|cls_token|pos_embedding|pos_emb|temperature|mask_token"
                   r"|distillation_token|reattn_weights|queries|mix_heads_(pre|post)_attn"
                   r"|layerscale_(attn|mlp)_\d+|positional_emb|class_emb)$")
# Batch statistics and where they go.
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def _encoder_stacks(tree, prefix=()):
    """Paths of the ``transformer_{i}`` modules that are ViT encoders (PiT's
    stages): each holds per-layer modules ``{attn_norm,attn,mlp_norm,mlp}_{j}``
    and nothing else."""
    for key, val in tree.items():
        if not (isinstance(val, dict) or hasattr(val, "items")):
            continue
        path = prefix + (str(key),)
        if _NUMBERED.match(path[-1]) and val and all(_ENCODER_LAYER.match(str(k)) for k in val):
            yield path
        yield from _encoder_stacks(val, path)


def _module_path(path: tuple, stacks=frozenset()) -> list:
    out = []
    for i, part in enumerate(path):
        m = _LAYER.match(part)
        staged = _STAGE_LAYER.match(part) if i and _STAGE.match(path[i - 1]) else None
        if m and (i == 0 or _STACK.match(path[i - 1]) or path[:i] in stacks):
            out += ["layers", m.group(2), m.group(1)]
        elif staged:
            out += ["layers", staged.group(2), staged.group(1)]
        elif part == "to_out":
            out += ["to_out", "0"]
        else:
            out.append(part)
    return out


def state_dict_from_flax(variables) -> dict:
    """Convert a Flax variables tree ``{"params": …, "batch_stats": …}`` (or
    the bare params tree) of NumPy arrays into a ``state_dict`` (f32
    tensors) for the port's counterpart of the module that made it: the
    models and objectives of the module docstring.

    Raises ``ValueError`` on a scanned tree (``scan_layers=True`` stacks the
    layers under ``transformer/layers``; unstack it with
    ``vit_tpu.layers.scan`` first) and on leaves it does not know.
    """
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {}) if "params" in variables else {}
    if "layers" in params.get("transformer", {}):
        raise ValueError("scanned (stacked) transformer tree: convert it to the "
                         "unrolled layout first (vit_tpu.layers.scan)")
    state, stacks = {}, frozenset(_encoder_stacks(params))
    leaves = [(path, leaf, False) for path, leaf in _flatten(params)]
    leaves += [(path, leaf, True) for path, leaf in _flatten(stats)]
    for path, leaf, is_stat in leaves:
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        *mods, name = path
        if is_stat:
            if name not in _STATS:
                raise ValueError(f"unknown batch statistic {'/'.join(path)}")
            name = _STATS[name]
        elif name == "kernel":
            if arr.ndim not in (2, 4):
                raise ValueError(f"{'/'.join(path)}: expected a Dense or Conv kernel, got "
                                 f"shape {arr.shape}")
            name, arr = "weight", arr.T if arr.ndim == 2 else arr.transpose(3, 2, 0, 1)
        elif name in ("scale", "embedding"):
            name = "weight"
        elif name in ("g", "b"):
            arr = arr.reshape(-1)
        elif not _KEPT.match(name):
            raise ValueError(f"unknown leaf {'/'.join(path)}")
        key = ".".join(_module_path(tuple(mods), stacks) + [name])
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state
