"""Trees of tensors, flattened in the JAX package's order.

The training state is a tree: dicts (keys in sorted order, as
``jax.tree.flatten`` takes them), NamedTuples and tuples (fields in
order), ``None`` (no leaves) and, for the parameters, a model module
(``models/model.py``), which stands for its nested dict of parameters.
Anything else is a leaf. The same order makes a checkpoint written by
either package readable by the other.
"""
from __future__ import annotations

from typing import Any, Iterator, List

from torch import nn


def module_tree(module: nn.Module) -> dict:
    """A module's parameters as a nested dict under their dotted names."""
    out: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        d = out
        for part in path:
            d = d.setdefault(part, {})
        d[leaf] = p
    return out


def leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree.flatten``'s order."""
    if isinstance(tree, nn.Module):
        return leaves(module_tree(tree))
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for child in tree for x in leaves(child)]
    if tree is None:
        return []
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), into a tree of that structure; a module
    maps as its parameter dict."""
    if isinstance(tree, nn.Module):
        return tree_map(fn, module_tree(tree), *(
            module_tree(r) if isinstance(r, nn.Module) else r for r in rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(template: Any, values) -> Any:
    """``values`` (in ``leaves(template)``'s order) in ``template``'s
    structure. A module in the template takes its values in place (its
    parameters are overwritten) and is returned itself."""
    it = iter(values)
    out = _fill(template, it)
    if next(it, None) is not None:
        raise ValueError("more values than the template has leaves")
    return out


def _fill(node: Any, it: Iterator) -> Any:
    if isinstance(node, nn.Module):
        for p in leaves(node):
            p.data.copy_(_next(it))
        return node
    if isinstance(node, dict):
        filled = {k: _fill(node[k], it) for k in sorted(node)}
        return {k: filled[k] for k in node}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_fill(child, it) for child in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_fill(child, it) for child in node)
    if node is None:
        return None
    return _next(it)


def _next(it: Iterator):
    try:
        return next(it)
    except StopIteration:
        raise ValueError("fewer values than the template has leaves") from None
