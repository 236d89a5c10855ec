"""Shared model plumbing: parameter trees, init helpers, gradients.

Params are nested dicts of tensors, as the JAX package's are nested
dicts of arrays.  A tree is flattened in JAX's order: a dict by sorted
key, a tuple or list by index, a NamedTuple by field, ``None`` holds no
leaf; anything else is a leaf.  A leaf's path is the tuple of keys down
to it, and ``path_str`` joins it with "/" as the JAX package's
``path_str`` joins its key entries, so checkpoint keys and parameter
names agree between the two packages.

The sharding helpers of the JAX module (``dp_axes``,
``resolve_template``, ``tree_param_specs``, ``guard_tree_specs``,
``tree_shardings``) map parameter trees onto a device mesh; they come
with the dry-run slice.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

PyTree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[Any, Any]]:
    """(key, child) pairs of an inner node in flattening order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    return None


def tree_leaves_with_path(tree: PyTree) -> List[Tuple[tuple, Any]]:
    """[(path, leaf)] in JAX's flattening order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [((), tree)]
    out = []
    for k, child in kids:
        out += [((k,) + p, leaf) for p, leaf in tree_leaves_with_path(child)]
    return out


def tree_leaves(tree: PyTree) -> list:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and the matching leaves (or
    subtrees) of ``rest``, keeping ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest])
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map(fn, c, *[r[i] for r in rest])
                            for i, c in enumerate(tree)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, c, *[r[i] for r in rest])
                          for i, c in enumerate(tree))
    return fn(tree, *rest)


def tree_flatten_up_to(structure: PyTree, tree: PyTree) -> list:
    """The subtrees of ``tree`` at the leaves of ``structure``, in
    flattening order (``treedef.flatten_up_to``)."""
    return [_at(tree, p) for p, _ in tree_leaves_with_path(structure)]


def tree_unflatten(structure: PyTree, leaves: list) -> PyTree:
    """``structure`` with its leaves replaced, in flattening order."""
    paths = [p for p, _ in tree_leaves_with_path(structure)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a tree of "
                         f"{len(paths)}")
    return _rebuild(structure, (), dict(zip(paths, leaves)))


def _rebuild(tree, prefix, by_path):
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return by_path[prefix]
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], prefix + (k,), by_path) for k in tree}
    new = [_rebuild(c, prefix + (k,), by_path) for k, c in kids]
    if _is_namedtuple(tree):
        return type(tree)(*new)
    return type(tree)(new)


def _at(tree, path):
    for k in path:
        tree = getattr(tree, k) if isinstance(k, str) and \
            _is_namedtuple(tree) else tree[k]
    return tree


def path_str(path) -> str:
    return "/".join(str(k) for k in path)


# ------------------------------------------------------------------ init
def uniform_init(gen: torch.Generator, shape, scale, dtype, device=None):
    """U(-scale, scale) drawn in fp32 from ``gen`` on its own device."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    x.uniform_(-scale, scale, generator=gen)
    return x.to(device=device or gen.device, dtype=dtype)


def normal_init(gen: torch.Generator, shape, std, dtype, device=None):
    """N(0, std^2) drawn in fp32 from ``gen`` on its own device.  The
    values are not JAX's for any seed: tests convert JAX's init
    (``models.convert``)."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return x.mul_(std).to(device=device or gen.device, dtype=dtype)


def count_params(tree: PyTree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(tree))


# ------------------------------------------------------------- gradients
def value_and_grad(fn: Callable) -> Callable:
    """``jax.value_and_grad``: (params, *args) -> (value, grads), grads
    shaped as ``params``.  Every floating leaf is differentiated; a leaf
    the value does not reach gets zeros."""

    def wrapped(params, *args):
        leaves = tree_leaves(params)
        xs = [x.detach().requires_grad_(x.is_floating_point())
              for x in leaves]
        value = fn(tree_unflatten(params, xs), *args)
        diff = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(value, diff, allow_unused=True))
        grads = []
        for x in xs:
            g = next(got) if x.requires_grad else None
            grads.append(torch.zeros_like(x) if g is None else g)
        return value.detach(), tree_unflatten(params, grads)

    return wrapped
