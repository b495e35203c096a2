"""Flax ``vit_tpu`` variables → the port's ``state_dict`` (the converse
direction of ``vit_tpu/interop/tf_weights.py``), for ``vit_tpu.ViT``,
``vit_tpu.models.vit_for_small_dataset.ViT``, ``vit_tpu.models.cvt.CvT`` and
``vit_tpu.models.scalable_vit.ScalableViT``.

The tree holds NumPy arrays (``jax.tree.map(np.asarray, variables)``), so no
JAX is imported here.  Leaves:
- Dense kernels ``(in, out)`` become ``weight = kernel.T``; Conv kernels
  (HWIO, ``(kh, kw, in, out)``, a depthwise ``GroupedConv``'s ``(kh, kw, 1,
  C)`` included) become OIHW ``weight``s;
- LayerNorm and BatchNorm ``scale`` / ``bias`` become ``weight`` / ``bias``;
  ``ChannelLayerNorm``'s ``g`` / ``b`` keep their names as ``(dim,)``
  vectors; BatchNorm's ``batch_stats`` ``mean`` / ``var`` become
  ``running_mean`` / ``running_var``;
- ``cls_token``, ``pos_embedding`` and LSA's scalar ``temperature`` keep
  their shapes.

Per-layer modules ``{attn_norm,attn,mlp_norm,mlp,mlp_fc1,mlp_fc2}_{i}`` map to
``layers.{i}.…``: under ``transformer`` for the ViT (``transformer/attn_0`` →
``transformer.layers.0.attn``), under each stage's ``s{1,2,3}_transformer``
for CvT, and at the top for the small-dataset ViT (``attn_0`` →
``layers.0.attn``).  ScalableViT's ``{ssa,ff1,iwsa,ff2}_{i}`` and their
``*_norm_{i}`` map to ``layers.{i}.…`` under each ``stage_{s}``
(``stage_0/iwsa_norm_1`` → ``stage_0.layers.1.iwsa_norm``); a stage's ``peg``
and ``norm`` keep their names.  ``to_out`` maps to ``to_out.0`` (the
projection before its dropout).  The small-dataset ViT's ``patch_embedding/norm`` and
``patch_embedding/proj`` keep their names; the proj kernel's rows stay in the
(p1, p2, group, c) order its SPT reads.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"^(attn_norm|attn|mlp_norm|mlp|mlp_fc1|mlp_fc2)_(\d+)$")
# ScalableViT's per-layer modules, under a stage_{s}.
_STAGE_LAYER = re.compile(r"^(ssa_norm|ssa|ff1_norm|ff1|iwsa_norm|iwsa|ff2_norm|ff2)_(\d+)$")
_STAGE = re.compile(r"^stage_\d+$")
# Batch statistics and where they go.
_STATS = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree, prefix=()):
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, dict) or hasattr(val, "items"):
            yield from _flatten(val, path)
        else:
            yield path, val


def _module_path(path: tuple) -> list:
    out = []
    for i, part in enumerate(path):
        m = _LAYER.match(part)
        staged = _STAGE_LAYER.match(part) if i and _STAGE.match(path[i - 1]) else None
        if m and (i == 0 or path[i - 1] == "transformer"
                  or path[i - 1].endswith("_transformer")):
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
    the bare params tree) of NumPy arrays into a ``state_dict`` for
    :class:`vit_tpu_torch.ViT`,
    :class:`vit_tpu_torch.models.vit_for_small_dataset.ViT`,
    :class:`vit_tpu_torch.CvT` or :class:`vit_tpu_torch.ScalableViT` (f32
    tensors).

    Raises ``ValueError`` on a scanned tree (``scan_layers=True`` stacks the
    layers under ``transformer/layers``; unstack it with
    ``vit_tpu.layers.scan`` first) and on leaves it does not know.
    """
    params = variables.get("params", variables)
    stats = variables.get("batch_stats", {}) if "params" in variables else {}
    if "layers" in params.get("transformer", {}):
        raise ValueError("scanned (stacked) transformer tree: convert it to the "
                         "unrolled layout first (vit_tpu.layers.scan)")
    state = {}
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
        elif name == "scale":
            name = "weight"
        elif name in ("g", "b"):
            arr = arr.reshape(-1)
        elif name not in ("bias", "cls_token", "pos_embedding", "temperature"):
            raise ValueError(f"unknown leaf {'/'.join(path)}")
        key = ".".join(_module_path(tuple(mods)) + [name])
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state
