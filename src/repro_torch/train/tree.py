"""Pytrees of tensors in the JAX package's order.

``jax.tree.leaves`` visits dict entries in sorted key order and tuple,
list and NamedTuple entries in order, and a registered dataclass (the
decode cache) field by field; an empty container and ``None`` give no
leaf.  The optimizer's global norm, the checkpoint's leaf files and
``train_state_from_jax`` all follow that order, so both packages read and
write the same leaves in the same places.
"""
from __future__ import annotations

import dataclasses


def _children(node):
    """(keys-in-order, rebuild) of a container, or None for a leaf."""
    if isinstance(node, dict):
        keys = sorted(node)
        return keys, lambda vals: dict(zip(keys, vals))
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(range(len(node))), lambda vals: type(node)(*vals)
    if isinstance(node, (tuple, list)):
        return list(range(len(node))), lambda vals: type(node)(vals)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        names = [f.name for f in dataclasses.fields(node)]
        return names, lambda vals: type(node)(*vals)
    return None


def _child(node, k):
    return getattr(node, k) if dataclasses.is_dataclass(node) else node[k]


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order (``None`` gives none)."""
    if tree is None:
        return []
    ch = _children(tree)
    if ch is None:
        return [tree]
    out = []
    for k in ch[0]:
        out.extend(leaves(_child(tree, k)))
    return out


def paths(tree, prefix=()) -> list:
    """Each leaf's path of keys joined by '/', in ``leaves`` order."""
    if tree is None:
        return []
    ch = _children(tree)
    if ch is None:
        return ["/".join(prefix)]
    out = []
    for k in ch[0]:
        out.extend(paths(_child(tree, k), prefix + (str(k),)))
    return out


def unflatten(like, values):
    """A tree shaped like ``like`` holding ``values`` in ``leaves`` order."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        ch = _children(node)
        if ch is None:
            return next(it)
        return ch[1]([build(_child(node, k)) for k in ch[0]])

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, shaped like ``tree``."""
    cols = [leaves(tree)] + [leaves(t) for t in rest]
    return unflatten(tree, [fn(*xs) for xs in zip(*cols)])
