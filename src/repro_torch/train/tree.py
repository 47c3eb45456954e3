"""Nested dicts of tensors, the port's counterpart of a JAX pytree.

The training state keeps the JAX package's trees: the parameters as
``lm.init`` returns them (superblock leaves stacked on a leading axis),
the optimizer state beside them.  Leaves are visited in sorted key
order, as ``jax.tree_util`` visits a dict, so a sum over leaves adds
them in the reference's order and a key path ("blocks/b0/attn/wq")
names the same leaf in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Tuple


def items(tree: Any, prefix: Tuple[str, ...] = ()
          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) of every leaf, in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in items(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of ``tree`` and the matching leaves of
    ``rest``, which have its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def get(tree: Dict, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def put(tree: Dict, path: Tuple[str, ...], leaf: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf
