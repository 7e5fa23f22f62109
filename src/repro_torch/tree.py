"""Nested dicts / lists / tuples of tensors (the port's params and
optimizer state), walked in ``jax.tree_util``'s order: dict keys sorted,
then list and tuple items in order.  A leaf is anything else."""
from __future__ import annotations


def _children(node):
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def leaves(tree) -> list:
    """The leaves of ``tree`` in order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, child in kids for leaf in leaves(child)]


def paths(tree) -> list:
    """Each leaf's path, its keys and indices joined by ``/`` (the JAX
    package's checkpoint leaf names)."""
    kids = _children(tree)
    if kids is None:
        return [""]
    return ["/".join(filter(None, (str(k), p)))
            for k, child in kids for p in paths(child)]


def map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching nodes of
    ``rest`` (same structure), into a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like, flat):
    """A tree of ``like``'s structure whose leaves are ``flat``, in
    :func:`leaves` order."""
    it = iter(flat)
    out = _fill(like, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the structure holds")
    return out


def _fill(node, it):
    if isinstance(node, dict):
        return {k: _fill(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_fill(child, it) for child in node)
    return next(it)


def flatten_up_to(structure, tree) -> list:
    """The nodes of ``tree`` that sit where ``structure`` has its leaves
    (``tree`` may hold a subtree at each)."""
    kids = _children(structure)
    if kids is None:
        return [tree]
    return [node for k, child in kids
            for node in flatten_up_to(child, tree[k])]
