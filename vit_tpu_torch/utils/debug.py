"""Debug-mode numerics guards (port of ``vit_tpu/utils/debug.py``).

``vit_tpu``'s ``checked`` runs checkify's float checks inside the compiled
program.  Here :func:`checked` runs the function under a
``TorchDispatchMode`` that looks at every floating output of every op as it
runs, the port's registered kernel ops included, and raises
``FloatingPointError`` naming the first op that made a NaN or an inf.  Index
errors already raise in PyTorch.  It is a debug tool: on the card each check
reads a flag on the host, a synchronisation per op.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _FiniteMode(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel() \
                    and not bool(torch.isfinite(t).all()):
                kind = "NaN" if bool(torch.isnan(t).any()) else "inf"
                raise FloatingPointError(f"{func} produced {kind} in an output of shape "
                                         f"{tuple(t.shape)}")
        return out


def checked(fn: Callable) -> Callable:
    """``fn`` with every op's floating outputs checked as they are made:
    ``checked(fn)(*args)`` returns ``fn``'s value, or raises
    ``FloatingPointError`` on the first NaN or inf, naming the op.  Not for
    the hot path."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _FiniteMode():
            return fn(*args, **kwargs)

    return wrapper


def _leaves(tree, prefix=()):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif isinstance(tree, torch.Tensor):
        yield prefix, tree


def assert_finite(tree, name: str = "tree") -> None:
    """Raise ``FloatingPointError`` naming the first leaf of ``tree`` (nested
    dicts, lists and tuples of tensors, or a module's ``state_dict``) that
    holds a NaN or an inf, its keys joined by ``/``."""
    for path, leaf in _leaves(tree):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name}:{'/'.join(path)}")
