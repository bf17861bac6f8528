"""Pytrees of the port: the trees that training state, gradients and
checkpoints are made of, flattened in the order ``jax.tree`` flattens the
reference's.

A node is a ``dict`` (children in sorted key order, as JAX sorts dict
keys), a ``list`` or ``tuple`` (in order), a dataclass instance such as
:class:`repro_torch.train.TrainState` (its fields in declaration order),
an ``nn.Module`` (its ``named_parameters()`` as a dict, so in sorted name
order), or ``None`` (no leaves, as in JAX).  Anything else is a leaf.  A
path is a tuple of ``("key", k)``, ``("index", i)`` and ``("attr",
name)`` entries; :func:`keystr` spells it as ``jax.tree_util.keystr``
does (``.params['layers']['mlp']['w_down']``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from torch import nn

__all__ = ["children", "leaves_with_path", "leaves", "keystr", "tree_map"]


def children(node) -> list[tuple[tuple[str, Any], Any]] | None:
    """``[(path entry, child), ...]`` of a node, or None for a leaf."""
    if node is None:
        return []
    if isinstance(node, nn.Module):
        node = dict(node.named_parameters())
    if isinstance(node, dict):
        return [(("key", k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(("index", i), c) for i, c in enumerate(node)]
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(("attr", f.name), getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def leaves_with_path(tree, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    """``(path, leaf)`` of every leaf of ``tree``, in JAX's order."""
    kids = children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for entry, c in kids for item in leaves_with_path(c, prefix + (entry,))]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def keystr(path: tuple) -> str:
    return "".join(f".{k}" if kind == "attr" else f"[{k!r}]" for kind, k in path)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), rebuilt in ``tree``'s structure; a module becomes the dict
    of its parameters' names."""
    kids = children(tree)
    if kids is None:
        return fn(tree, *rest)
    if tree is None:
        return None
    sub = [children(r) for r in rest]
    for s in sub:
        if s is None or [e for e, _ in s] != [e for e, _ in kids]:
            raise ValueError("tree_map: the trees differ in structure")
    mapped = {e: tree_map(fn, c, *(s[i][1] for s in sub)) for i, (e, c) in enumerate(kids)}
    if isinstance(tree, (nn.Module, dict)):
        return {k: mapped[("key", k)] for _, k in mapped}
    if isinstance(tree, (list, tuple)):
        return type(tree)(mapped[("index", i)] for i in range(len(kids)))
    return dataclasses.replace(tree, **{k: v for (_, k), v in mapped.items()})
