"""Tree helpers over nested dicts, lists and tuples of tensors or arrays.

Counterpart of ``repro.utils.tree``.  A tree is what the port's
parameters and optimizer state are: dicts, lists and tuples whose
leaves are ``torch.Tensor`` or ``numpy.ndarray`` (``None`` is an empty
subtree, as in JAX).  Leaves are visited in JAX's order: dict keys
sorted, sequences in index order.  A leaf's path string is the
reference's ``_path_str``: dict keys and sequence indices joined by
``/``.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import numpy as np
import torch


def leaves_with_path(tree: Any, prefix: tuple = ()
                     ) -> Iterator[tuple[tuple, Any]]:
    """(path parts, leaf) for every leaf, in JAX's order; the parts are
    the dict keys and sequence indices from the root."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def _path_str(parts: tuple) -> str:
    return "/".join(str(p) for p in parts)


def tree_leaves(tree: Any) -> list:
    """Every leaf, in JAX's order (``jax.tree.leaves``)."""
    return [x for _, x in leaves_with_path(tree)]


def _itemsize(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.element_size()
    return np.dtype(x.dtype).itemsize


def tree_size(tree: Any) -> int:
    """Total number of elements across all leaves."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    """Total bytes across all leaves (uses leaf dtype itemsize)."""
    return sum(int(np.prod(x.shape)) * _itemsize(x) for x in tree_leaves(tree))


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Map ``fn(path_string, leaf)`` over a tree; the result has the
    tree's structure, and ``fn`` is called in JAX's leaf order."""
    out = {_path_str(p): fn(_path_str(p), x)
           for p, x in leaves_with_path(tree)}

    def rebuild(t, prefix):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: rebuild(v, prefix + (k,)) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(rebuild(v, prefix + (i,)) for i, v in enumerate(t))
        return out[_path_str(prefix)]

    return rebuild(tree, ())


def tree_paths(tree: Any) -> list[str]:
    return [_path_str(p) for p, _ in leaves_with_path(tree)]
