"""Nested dicts and lists of tensors: the port's param and state trees.

Leaves come in the reference's order: a dict's keys sorted, a list's
items in order (JAX's flattening order), and each leaf's path is the
reference's ``keystr`` (``"['segments'][0]['l0']['mix']['wq']"``), so a
checkpoint's leaf names match the reference's.  ``is_leaf`` stops the
walk at a node (an optimizer's per-parameter state dict).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

__all__ = ["leaves", "leaves_with_path", "tree_map", "tree_unflatten"]


def _walk(tree: Any, path: str, is_leaf: Callable[[Any], bool] | None
          ) -> Iterator[tuple[str, Any]]:
    if is_leaf is not None and is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}[{k!r}]", is_leaf)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}[{i}]", is_leaf)
    else:
        yield path, tree


def leaves_with_path(tree: Any, is_leaf: Callable[[Any], bool] | None = None
                     ) -> list[tuple[str, Any]]:
    """[(keystr path, leaf)] in the reference's order."""
    return list(_walk(tree, "", is_leaf))


def leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None
           ) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [v for _, v in _walk(tree, "", is_leaf)]


def tree_unflatten(spec: Any, values: list,
                   is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """A tree shaped as ``spec`` whose leaves are ``values``, in the
    order `leaves` gives ``spec``'s."""
    it = iter(values)

    def build(node: Any) -> Any:
        if is_leaf is not None and is_leaf(node):
            return next(it)
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}  # the spec's own key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("more values than the spec has leaves")
    return out


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees ``rest`` of the
    same structure, leaf by leaf."""
    cols = [leaves(tree, is_leaf)] + [leaves(t, is_leaf) for t in rest]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*cols)], is_leaf)
