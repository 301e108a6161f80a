"""Parameter trees: nested dicts / lists / tuples of tensors.

The order is JAX's pytree order — dict keys sorted, lists and tuples by
index — so ``leaves(tree)`` lines up one to one with
``jax.tree.leaves`` of the same nested structure, and a path-keyed
checkpoint or a flat wire buffer is the same on both sides.
"""
from __future__ import annotations


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def _walk(tree, prefix, out):
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            out.append(("/".join(prefix), tree))
        return out
    for k, c in kids:
        _walk(c, prefix + [str(k)], out)
    return out


# The walkers are module-level functions, not closures: a recursive nested
# function is a reference cycle that would keep every leaf it collected
# (whole model copies on the card) alive until the garbage collector runs.
def leaves(tree):
    """Leaves in JAX order (``None`` and empty containers hold none)."""
    return [leaf for _, leaf in _walk(tree, [], [])]


def leaves_with_path(tree):
    """``[(path, leaf)]`` in JAX order; ``path`` joins keys and indices with
    ``/`` exactly as ``repro/checkpoint/io.py`` names its npz entries."""
    return _walk(tree, [], [])


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of one structure; containers are
    rebuilt with their own type (dict key order kept as in ``tree``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def _rebuild(t, it):
    if isinstance(t, dict):
        built = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)([_rebuild(c, it) for c in t])
    if t is None:
        return None
    return next(it)


def unflatten_like(tree, new_leaves):
    """Rebuild ``tree``'s structure with ``new_leaves`` (JAX order)."""
    it = iter(new_leaves)
    out = _rebuild(tree, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has slots")
    return out
