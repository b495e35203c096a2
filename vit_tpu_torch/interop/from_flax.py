"""Flax ``vit_tpu`` parameters → the port's ``state_dict`` (the converse
direction of ``vit_tpu/interop/tf_weights.py``), for ``vit_tpu.ViT`` and
``vit_tpu.models.vit_for_small_dataset.ViT``.

The tree holds NumPy arrays (``jax.tree.map(np.asarray, variables)``), so no
JAX is imported here.  Dense kernels ``(in, out)`` become ``weight = kernel.T``;
LayerNorm ``scale`` / ``bias`` become ``weight`` / ``bias``; ``cls_token``,
``pos_embedding`` and LSA's scalar ``temperature`` keep their shapes.
Per-layer modules ``{attn_norm,attn,mlp_norm,mlp}_{i}`` map to
``layers.{i}.{attn_norm,attn,mlp_norm,mlp}``, under ``transformer`` for the
ViT (``transformer/attn_0`` → ``transformer.layers.0.attn``) and at the top
for the small-dataset ViT (``attn_0`` → ``layers.0.attn``), and ``to_out`` to
``to_out.0`` (the projection before its dropout).  The small-dataset ViT's
``patch_embedding/norm`` and ``patch_embedding/proj`` keep their names; the
proj kernel's rows stay in the (p1, p2, group, c) order its SPT reads.
"""

from __future__ import annotations

import re

import numpy as np
import torch

_LAYER = re.compile(r"^(attn_norm|attn|mlp_norm|mlp)_(\d+)$")


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
        if m and (i == 0 or path[i - 1] == "transformer"):
            out += ["layers", m.group(2), m.group(1)]
        elif part == "to_out":
            out += ["to_out", "0"]
        else:
            out.append(part)
    return out


def state_dict_from_flax(params) -> dict:
    """Convert a Flax ``{"params": …}`` tree (or the inner tree) of NumPy
    arrays into a ``state_dict`` for :class:`vit_tpu_torch.ViT` or
    :class:`vit_tpu_torch.models.vit_for_small_dataset.ViT` (f32 tensors).

    Raises ``ValueError`` on a scanned tree (``scan_layers=True`` stacks the
    layers under ``transformer/layers``; unstack it with
    ``vit_tpu.layers.scan`` first) and on leaves it does not know.
    """
    if "params" in params:
        params = params["params"]
    if "layers" in params.get("transformer", {}):
        raise ValueError("scanned (stacked) transformer tree: convert it to the "
                         "unrolled layout first (vit_tpu.layers.scan)")
    state = {}
    for path, leaf in _flatten(params):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        *mods, name = path
        if name == "kernel":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a Dense kernel, got "
                                 f"shape {arr.shape}")
            name, arr = "weight", arr.T
        elif name == "scale":
            name = "weight"
        elif name not in ("bias", "cls_token", "pos_embedding", "temperature"):
            raise ValueError(f"unknown leaf {'/'.join(path)}")
        key = ".".join(_module_path(tuple(mods)) + [name])
        state[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return state
