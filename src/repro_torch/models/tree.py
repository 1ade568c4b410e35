"""Walks over the nested dict/list trees that hold parameters and caches
(the counterpart of ``jax.tree`` for this package)."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_named(fn, tree, name: str = ""):
    """Apply ``fn(name, leaf)``; ``name`` is the dict key the leaf sits
    under (list items keep their parent's key)."""
    if isinstance(tree, dict):
        return {k: tree_map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def tree_map_with_path(fn, tree, path: tuple = ()):
    """Apply ``fn(path, leaf)``; ``path`` is the tuple of dict keys and
    list indices down to the leaf (``jax.tree_util.tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_flatten_with_path(tree, path: str = "") -> list:
    """[(path, leaf)] in the reference's pytree order (dict keys sorted,
    list items in order), each path spelled as
    ``jax.tree_util.keystr`` spells it, e.g.
    ``"['groups'][0]['stacked']['b0']['mixer']['A_log']"``.  AdamW's decay
    mask and the checkpoint keys read these names."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_flatten_with_path(v, f"{path}[{i}]")]
    return [(path, tree)]
