"""Weights between the JAX package and the port.

A JAX parameter tree, taken to numpy (``jax.tree.map(np.asarray, p)``:
nested dicts and lists keyed as ``path_str`` keys them), becomes the
port's module for its config (``Transformer``, ``GNN``, ``MACE`` or
``Bert4Rec``) with the same names, shapes and dtypes, and back.  The
port's own init draws other random values than JAX's, so every test
that holds the port against JAX converts JAX's init through here.
"""
from __future__ import annotations

import numpy as np
import torch

from .bert4rec import Bert4Rec, Bert4RecConfig
from .common import PyTree, _ParamTree, tree_leaves_with_path, tree_map
from .gnn import GNN, GNNConfig
from .mace import MACE, MACEConfig
from .transformer import Transformer, TransformerConfig

# each family's config -> its module
_MODULES = {TransformerConfig: Transformer, GNNConfig: GNN,
            MACEConfig: MACE, Bert4RecConfig: Bert4Rec}


def tensor_from_numpy(a, device=None, dtype=None) -> torch.Tensor:
    """One array as a tensor.  bfloat16 arrives as ml_dtypes' bfloat16
    (or as the raw 2-byte void records ``np.load`` gives for it) and is
    reinterpreted bit for bit."""
    a = np.asarray(a)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype or t.dtype)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """One tensor as an array; bfloat16 goes out as raw 2-byte void
    records, the form a bfloat16 array takes in an ``.npz``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def tree_from_numpy(tree: PyTree, device=None) -> PyTree:
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)


def params_from_numpy(tree: PyTree, cfg, device=None) -> _ParamTree:
    """The JAX tree (numpy leaves) as the port's module for ``cfg`` on
    ``device``: a GNN's list of layer dicts, MACE's dicts and layer
    list, BERT4Rec's and the transformer's stacked blocks."""
    return _MODULES[type(cfg)](cfg, tree_from_numpy(tree, device))


def load_numpy(module: _ParamTree, tree: PyTree) -> None:
    """Copy a numpy tree into ``module``'s parameters in place; paths
    and shapes must match."""
    own = dict(tree_leaves_with_path(module.tree()))
    new = dict(tree_leaves_with_path(tree))
    if set(own) != set(new):
        raise KeyError(f"paths differ: {sorted(set(own) ^ set(new))}")
    with torch.no_grad():
        for path, val in new.items():
            p = own[path]
            src = tensor_from_numpy(val)
            if tuple(src.shape) != tuple(p.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)} != "
                                 f"{tuple(p.shape)}")
            p.copy_(src.to(p.dtype))


def params_to_numpy(params) -> PyTree:
    """A module's (or a tree's) parameters as the JAX-shaped numpy tree."""
    if isinstance(params, _ParamTree):
        params = params.tree()
    return tree_map(tensor_to_numpy, params)
