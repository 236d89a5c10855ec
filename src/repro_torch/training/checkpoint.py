"""Model/optimizer checkpointing: atomic, async-capable, and in the JAX
package's format.

Leaves are copied to host numpy and written as one ``.npz`` per
checkpoint, keyed by their tree path joined with "|" (``0|sub1|moe|wr``,
``1|m|sub1|moe|shared_wg|q`` for ``(params, AdamWState)``), plus a JSON
manifest, each through tmp + rename so a reader never sees a partial
file.  The keys and dtypes are JAX's, so a checkpoint written by either
package is read by the other.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..models.common import path_str, tree_leaves_with_path, tree_unflatten
from ..models.convert import tensor_from_numpy, tensor_to_numpy

PyTree = Any
_SEP = "|"


def _key(path) -> str:
    return path_str(path).replace("/", _SEP)


def _flatten(tree: PyTree) -> Dict[str, np.ndarray]:
    return {_key(p): tensor_to_numpy(torch.as_tensor(leaf))
            for p, leaf in tree_leaves_with_path(tree)}


def save(path: str, tree: PyTree, step: int, meta: Optional[dict] = None,
         async_: bool = False):
    """Write ``tree`` at ``path``; with ``async_`` the write runs on a
    thread (returned, to join) after the leaves were copied to host."""
    flat = _flatten(tree)

    def _write():
        d = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-")
        os.close(fd)
        try:
            np.savez(tmp, **flat)
            os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp,
                       path)
        finally:
            for t in (tmp, tmp + ".npz"):
                if os.path.exists(t):
                    os.unlink(t)
        with open(path + ".meta.json.tmp", "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        os.replace(path + ".meta.json.tmp", path + ".meta.json")

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    return None


def restore(path: str, like: PyTree, device=None) -> tuple:
    """Rebuild the tree of ``like`` from the checkpoint; returns
    (tree, step).  Each leaf takes ``like``'s dtype and device (``device``
    where given, or where ``like`` is on ``meta``)."""
    with np.load(path, allow_pickle=False) as data:
        with open(path + ".meta.json") as f:
            meta = json.load(f)
        leaves = []
        for p, leaf in tree_leaves_with_path(like):
            key = _key(p)
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"{key}: shape {arr.shape} in {path}, "
                                 f"expected {tuple(leaf.shape)}")
            dev = device or (None if leaf.device.type == "meta"
                             else leaf.device)
            leaves.append(tensor_from_numpy(arr, dev, leaf.dtype))
    return tree_unflatten(like, leaves), meta["step"]
