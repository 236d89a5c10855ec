"""Shared model plumbing: parameter trees, init helpers, gradients.

Params are nested dicts of tensors, as the JAX package's are nested
dicts of arrays.  A tree is flattened in JAX's order: a dict by sorted
key, a tuple or list by index, a NamedTuple by field, ``None`` holds no
leaf; anything else is a leaf.  A leaf's path is the tuple of keys down
to it, and ``path_str`` joins it with "/" as the JAX package's
``path_str`` joins its key entries, so checkpoint keys and parameter
names agree between the two packages.

Sharding is expressed as in the JAX module: an ordered list of
(path-regex, spec template) rules (``Rules``); a template may name the
symbolic axes "DATA" (every pure-DP axis: ``("pod", "data")`` on the
multi-pod mesh, ``"data"`` on one pod - FSDP/ZeRO sharding) and "MODEL"
(the tensor/expert-parallel axis).  ``resolve_template`` instantiates
one for a ``DeviceMesh`` as a ``P`` (the port's ``PartitionSpec``), and
``tree_shardings`` turns a tree of specs into DTensor placements, the
counterpart of ``NamedSharding``.  The helpers read only the mesh's
axis names and sizes.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, List, Sequence, Tuple

import torch
from torch import nn

PyTree = Any
Rules = List[Tuple[str, Tuple]]  # (regex, axis template tuple)


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


# -------------------------------------------------------------- sharding
class P(tuple):
    """``jax.sharding.PartitionSpec``: one entry per leading tensor dim,
    each a mesh axis name, a tuple of names, or None (replicated).
    Equal, as a tuple, to JAX's spec for the same template."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axes_size(mesh, ax) -> int:
    """The number of shards a spec entry (a name or tuple) makes."""
    names = _axis_names(mesh)
    axes = ax if isinstance(ax, tuple) else (ax,)
    return math.prod(mesh.size(names.index(a)) for a in axes)


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _axis_names(mesh) if a in ("pod", "data"))


def _resolve_axis(ax, mesh):
    if isinstance(ax, tuple):
        out = []
        for a in ax:
            r = _resolve_axis(a, mesh)
            if isinstance(r, tuple):
                out.extend(r)
            elif r is not None:
                out.append(r)
        return tuple(out)
    if ax == "DATA":
        axes = dp_axes(mesh)
        return axes if len(axes) > 1 else axes[0]
    if ax == "MODEL":
        return "model"
    return ax


def resolve_template(tpl: Sequence, mesh) -> P:
    return P(*[_resolve_axis(a, mesh) for a in tpl])


def _guard(spec: Sequence, shape, mesh) -> P:
    """``spec`` over a tensor of ``shape``: cut to its dims, and every
    dim the entry's shard count does not divide replicated."""
    entries = tuple(spec)[:len(shape)]
    return P(*[None if ax is None or shape[d] % axes_size(mesh, ax)
               else ax for d, ax in enumerate(entries)],
             *[None] * (len(shape) - len(entries)))


def tree_param_specs(tree: PyTree, rules: Rules, mesh) -> PyTree:
    """Map every leaf to a ``P`` via the first rule whose regex matches
    its ``path_str``; size-1 / indivisible dims fall back to
    replication (e.g. quantized-optimizer scale tensors); no rule, P()."""
    paths = tree_leaves_with_path(tree)
    specs = []
    for path, leaf in paths:
        p = path_str(path)
        spec = P()
        for pat, tpl in rules:
            if re.search(pat, p):
                spec = _guard(resolve_template(tpl, mesh), leaf.shape, mesh)
                break
        specs.append(spec)
    return tree_unflatten(tree, specs)


def guard_tree_specs(args: PyTree, specs: PyTree, mesh) -> PyTree:
    """Replace spec axes that do not evenly divide the argument dim with
    replication (applied to batch/cache specs after template resolve)."""
    return tree_unflatten(args, [
        _guard(spec, leaf.shape, mesh) if isinstance(spec, P) else spec
        for leaf, spec in zip(tree_leaves(args),
                              tree_flatten_up_to(args, specs))])


def spec_placements(spec: Sequence, mesh) -> list:
    """A ``P`` as DTensor placements, one per mesh dim: ``Shard(d)`` on
    every mesh axis that splits tensor dim ``d``, ``Replicate()`` on the
    rest.  A dim split over several axes is JAX's block layout only
    with the axes in mesh order; any other order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} lists mesh axes out of the "
                             f"mesh's order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} splits two dims "
                                 f"in {spec}")
            out[i] = Shard(d)
    return out


def tree_shardings(tree: PyTree, rules: Rules, mesh) -> PyTree:
    """The placements (``spec_placements``) of ``tree_param_specs``."""
    specs = tree_flatten_up_to(tree, tree_param_specs(tree, rules, mesh))
    return tree_unflatten(tree, [spec_placements(s, mesh) for s in specs])


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


# ---------------------------------------------------------- segment ops
def _segment_slots(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Each id as a slot of ``n + 1`` rows: an id outside ``[0, n)``
    goes to the spare last slot, which the caller drops."""
    ids = ids.long()
    return torch.where((ids >= 0) & (ids < n), ids, n)


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(data, ids, num_segments=n)``: rows summed by
    id (``index_add``), an id outside ``[0, n)`` dropped, an empty
    segment 0.  On CUDA the sums are atomic, in no fixed order."""
    out = data.new_zeros((n + 1,) + tuple(data.shape[1:]))
    return out.index_add(0, _segment_slots(ids, n), data)[:n]


class _SegmentMax(torch.autograd.Function):
    """``scatter_reduce`` "amax" over a ``-inf`` start, with JAX's
    gradient: a segment's gradient splits evenly among the entries equal
    to its max, the ``-inf`` start counting as one where the max is
    ``-inf``; a segment whose max is NaN passes none (torch's own
    backward gives its entries NaN)."""

    @staticmethod
    def forward(ctx, data, slots, n):
        out = data.new_full((n + 1,) + tuple(data.shape[1:]), -torch.inf)
        idx = slots.reshape(-1, *[1] * (data.ndim - 1)).expand_as(data)
        out = out.scatter_reduce(0, idx, data, "amax", include_self=True)
        ctx.save_for_backward(data, slots, out)
        return out[:n]

    @staticmethod
    def backward(ctx, grad):
        data, slots, out = ctx.saved_tensors
        hit = data == out[slots]
        cnt = (out == -torch.inf).to(data.dtype).index_add(
            0, slots, hit.to(data.dtype))
        grad = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
        return torch.where(hit, grad[slots] / cnt[slots], 0.0), None, None


def segment_max(data: torch.Tensor, ids: torch.Tensor,
                n: int) -> torch.Tensor:
    """``jax.ops.segment_max(data, ids, num_segments=n)``: the row-wise
    max by id, an id outside ``[0, n)`` dropped, an empty segment
    ``-inf``, and JAX's gradient (``_SegmentMax``)."""
    return _SegmentMax.apply(data, _segment_slots(ids, n), n)


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


# ---------------------------------------------------------------- modules
class _ParamTree(nn.Module):
    """A nested tree of tensors held as parameters: a dict or a list
    becomes a child module (a list's entries named "0", "1", ...), a
    tensor a parameter of the same name, so ``named_parameters()``
    gives the tree's paths joined by "."."""

    def __init__(self, tree: PyTree):
        super().__init__()
        self._is_list = isinstance(tree, list)
        items = list(enumerate(tree) if self._is_list else tree.items())
        self._keys = [str(k) for k, _ in items]
        for key, val in items:
            if isinstance(val, (dict, list)):
                self.add_module(str(key), _ParamTree(val))
            else:
                self.register_parameter(str(key), nn.Parameter(
                    val, requires_grad=val.is_floating_point()))

    def tree(self) -> PyTree:
        """The live parameters as the JAX-shaped dict (or list)."""
        vals = [getattr(self, key) for key in self._keys]
        vals = [v.tree() if isinstance(v, _ParamTree) else v for v in vals]
        return vals if self._is_list else dict(zip(self._keys, vals))
