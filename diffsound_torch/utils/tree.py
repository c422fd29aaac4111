"""Nested dicts of tensors (the port's parameter trees): flatten, rebuild,
detach, and fresh leaves for an optimiser."""

from __future__ import annotations


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, depth first in insertion order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves):
    """A dict shaped like `tree` holding `leaves` in tree_leaves' order."""
    it = iter(leaves)

    def build(t):
        return {k: build(v) for k, v in t.items()} if isinstance(t, dict) else next(it)

    return build(tree)


def fresh_leaves(params):
    """(a copy of params whose tensors are fresh leaves requiring grad, the
    list of those leaves in tree_leaves' order)."""
    leaves = [x.detach().clone().requires_grad_(True) for x in tree_leaves(params)]
    return tree_unflatten(params, leaves), leaves


def detach_tree(params):
    """params with every tensor detached."""
    return tree_unflatten(params, [x.detach() for x in tree_leaves(params)])
