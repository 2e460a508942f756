"""Pytrees of tensors: nested dicts, lists and tuples, walked in the
reference's order (``jax.tree_util``: dict keys sorted, sequences in
order, ``None`` an empty subtree).

One walker serves the optimizer (leaves zipped across the params, grads
and moment trees), the checkpoint (leaf paths in ``jax.tree_util.keystr``
form, e.g. ``['dec'][0]['e0']['attn']['wq']['w']``), gradient compression
and the swap store.
"""
from __future__ import annotations


def leaves_with_paths(tree, prefix: str = "") -> list:
    """(keystr path, leaf) for every leaf, in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaves_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in leaves_with_paths(v, f"{prefix}[{i}]")]
    return [] if tree is None else [(prefix, tree)]


def flat_up_to(tree, other) -> list:
    """``other``'s subtrees at ``tree``'s leaves, in ``tree``'s leaf order
    (``other`` has ``tree``'s structure down to its leaves)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flat_up_to(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flat_up_to(v, other[i])]
    return [] if tree is None else [other]


def tree_leaves(tree) -> list:
    return flat_up_to(tree, tree)


def tree_unflatten(tree, leaves: list):
    """``tree``'s structure (its dicts' key order kept) with its leaves, in
    ``tree_leaves`` order, replaced by ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return node if node is None else next(it)

    return build(tree)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure; the result has
    the first tree's structure."""
    return tree_unflatten(trees[0], [
        fn(*xs) for xs in zip(*(flat_up_to(trees[0], t) for t in trees))])
