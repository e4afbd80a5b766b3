"""Nested containers of tensors ("trees") walked in the JAX package's
order: a dict's entries by sorted key, a list's or tuple's by index, as
``jax.tree`` flattens them. The
optimizer's leaf order and the checkpoint's files follow it, so that a
checkpoint's ``leaf_%05d.npy`` is the same leaf in both packages."""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

__all__ = ["items", "leaves", "tree_map", "unflatten"]


def items(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` pairs; a path holds the dict keys and the list
    indices (as strings) from the root to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, path + (str(i),))
    else:
        yield path, tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in items(tree)]


def unflatten(like: Any, new_leaves) -> Any:
    """A tree of ``like``'s structure whose leaves are ``new_leaves``, taken
    in :func:`items`' order (dicts keep ``like``'s insertion order)."""
    new_leaves = list(new_leaves)
    count = len(leaves(like))
    if len(new_leaves) != count:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {count}")
    return _build(like, iter(new_leaves))


def _build(like: Any, it: Iterator[Any]) -> Any:
    # a module-level function: a recursive closure would hold the leaves in
    # a reference cycle, which frees them only at the next cyclic collection
    if isinstance(like, dict):
        out = {k: _build(like[k], it) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_build(v, it) for v in like)
    return next(it)


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each of
    ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, (fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))))
