"""Shard-by-pattern / shard-by-subtree serving over a device mesh.

Mirrors mining/distributed.py's layout: query sequences shard over the
"data" axis, the pattern bank (step programs + metadata rows) shards
over the "model" axis.  Containment cells are embarrassingly parallel -
cell (b, p) touches only sequence b and pattern p - so the join needs no
collective: each rank computes its [B_loc, P_loc] block.  The step's one
collective is the all_gather that assembles the [B, P] matrices on
every rank, since the JAX package's step returns the global array.

Flat banks shard by pattern row (``make_serving_step``): rows must
divide the pattern axis; compile with ``pad_patterns_to`` a multiple of
the mesh's model-axis size (padding rows report no containment).

Trie banks shard by *subtree* (``make_trie_serving_step``): splitting a
trie by pattern row would tear shared prefixes apart and re-replicate
their work, so ``TrieBank.shard`` partitions the root's depth-1
subtrees across shards (greedy node-count balancing) and every shard
joins its own intact sub-trie.  ``stack_trie_shards`` pads the shard
tries to a common (depth, level width, pattern rows) and concatenates
them along the node/pattern axes; the step's output columns follow the
concatenated shard pattern order (``patterns`` in the stack), not the
original bank order.

Every rank is handed the same global tensors, takes its block by its
mesh coordinates and joins it with ``batch.batch_contains`` /
``batch.trie_contains``: the containment kernel on a CUDA mesh, its
plain version on a CPU mesh.  The mesh must span the world.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..collectives import (
    all_gather,
    axes_index,
    check_device,
    mesh_coords,
    rank_device,
    shard_block,
)
from .batch import batch_contains, trie_contains
from .trie import TrieBank


def _gather_blocks(mesh: DeviceMesh, db_axis: str, pat_axis: str):
    """``gather(contained, overflow)``: every rank's [B_loc, P_loc]
    blocks -> the [B, P] bool matrices, on every rank.  One all_gather
    over the world of the two bits packed in a byte; ranks that differ
    only on other axes hold equal blocks."""
    if sorted(mesh.mesh.flatten().tolist()) != \
            list(range(dist.get_world_size())):
        raise ValueError("the serving steps need a mesh over the world")
    names = mesh.mesh_dim_names
    db_d, pat_d = names.index(db_axis), names.index(pat_axis)
    where = {r: (c[db_d], c[pat_d]) for r, c in mesh_coords(mesh).items()}
    n_db, n_pat = mesh.size(db_d), mesh.size(pat_d)

    def gather(contained, overflow):
        packed = contained.to(torch.uint8) | (overflow.to(torch.uint8) << 1)
        bl, pl = packed.shape
        out = packed.new_empty((n_db * bl, n_pat * pl))
        for r, blk in enumerate(all_gather(packed, None)):
            i, j = where[r]
            out[i * bl:(i + 1) * bl, j * pl:(j + 1) * pl] = blk
        return (out & 1).bool(), (out & 2).bool()

    return gather


def make_serving_step(
    mesh: DeviceMesh,
    *,
    nv: int,
    n_label_keys: int,
    emax: int = 8,
    tmax: int = 16,
    db_axis: str = "data",
    pat_axis: str = "model",
):
    """Build the SPMD containment step over ``mesh``.

    Returns ``step(tokens [B,T,6], steps [P,L,F], pattern_valid [P]) ->
    (contained [B,P] bool, overflow [B,P] bool)`` on every rank, the
    rank joining its rows of B (split over ``db_axis``) with its rows of
    P (split over ``pat_axis``)."""
    gather = _gather_blocks(mesh, db_axis, pat_axis)
    device = rank_device(mesh)

    def step(tokens, steps, pattern_valid):
        check_device(device, tokens=tokens, steps=steps,
                     pattern_valid=pattern_valid)
        b, n_b = axes_index(mesh, (db_axis,))
        p, n_p = axes_index(mesh, (pat_axis,))
        rows = shard_block(tokens.shape[0], n_b, b, "query sequences")
        pats = shard_block(steps.shape[0], n_p, p, "pattern rows")
        if pattern_valid.shape[0] != steps.shape[0]:
            raise ValueError("steps and pattern_valid differ in rows")
        return gather(*batch_contains(
            tokens[rows], steps[pats], pattern_valid[pats],
            nv=nv, n_label_keys=n_label_keys, emax=emax, tmax=tmax,
        ))

    return step


def stack_trie_shards(shards: List[TrieBank]) -> Dict[str, object]:
    """Pad shard tries to common shapes and concatenate for the mesh.

    Returns arrays keyed ``lvl_steps`` [D, S*Mh, F], ``lvl_parent_pos``
    [D, S*Mh], ``term_level``/``term_pos``/``pattern_valid`` [S*Pl]
    (term positions stay shard-local - exactly what each rank's local
    [D, Mh] block indexes), plus ``patterns`` (the concatenated pattern
    list, output-column order) and ``rows_per_shard`` = Pl."""
    S = len(shards)
    D = max(max(t.depth, 1) for t in shards)
    Mh = max(
        max((len(lv) for lv in t.levels), default=1) for t in shards
    )
    Pl = max(t.bank.n_rows for t in shards)
    steps, parent_pos = [], []
    term_level, term_pos, pvalid = [], [], []
    patterns = []
    for t in shards:
        lv = t.padded_levels(depth=D, width=Mh)
        steps.append(lv.steps)
        parent_pos.append(lv.parent_pos)
        pad = Pl - t.bank.n_rows
        term_level.append(np.pad(lv.term_level, (0, pad)))
        term_pos.append(np.pad(lv.term_pos, (0, pad)))
        pvalid.append(np.pad(t.bank.pattern_valid, (0, pad)))
        patterns.append(t.bank.patterns)
    return {
        "lvl_steps": np.concatenate(steps, axis=1),
        "lvl_parent_pos": np.concatenate(parent_pos, axis=1),
        "term_level": np.concatenate(term_level),
        "term_pos": np.concatenate(term_pos),
        "pattern_valid": np.concatenate(pvalid),
        "patterns": patterns,
        "rows_per_shard": Pl,
        "n_shards": S,
    }


def make_trie_serving_step(
    mesh: DeviceMesh,
    *,
    nv: int,
    n_label_keys: int,
    emax: int = 8,
    tmax: int = 16,
    db_axis: str = "data",
    pat_axis: str = "model",
):
    """The trie counterpart of ``make_serving_step``: each rank joins
    one intact sub-trie (see ``stack_trie_shards``) against its local
    sequence block.

    Returns ``step(tokens [B,T,6], lvl_steps [D,S*Mh,F],
    lvl_parent_pos [D,S*Mh], term_level [P], term_pos [P],
    pattern_valid [P]) -> (contained [B,P] bool, overflow [B,P] bool)``
    on every rank, B split over ``db_axis`` and the node/pattern axes
    over ``pat_axis``."""
    gather = _gather_blocks(mesh, db_axis, pat_axis)
    device = rank_device(mesh)

    def step(tokens, lvl_steps, lvl_parent_pos, term_level, term_pos,
             pattern_valid):
        check_device(device, tokens=tokens, lvl_steps=lvl_steps,
                     lvl_parent_pos=lvl_parent_pos, term_level=term_level,
                     term_pos=term_pos, pattern_valid=pattern_valid)
        b, n_b = axes_index(mesh, (db_axis,))
        p, n_p = axes_index(mesh, (pat_axis,))
        rows = shard_block(tokens.shape[0], n_b, b, "query sequences")
        nodes = shard_block(lvl_steps.shape[1], n_p, p, "trie level width")
        if lvl_parent_pos.shape[1] != lvl_steps.shape[1]:
            raise ValueError("lvl_steps and lvl_parent_pos differ in width")
        pats = shard_block(pattern_valid.shape[0], n_p, p, "pattern rows")
        for name, x in (("term_level", term_level), ("term_pos", term_pos)):
            if x.shape[0] != pattern_valid.shape[0]:
                raise ValueError(f"{name} and pattern_valid differ in rows")
        return gather(*trie_contains(
            tokens[rows], lvl_steps[:, nodes].contiguous(),
            lvl_parent_pos[:, nodes].contiguous(),
            term_level[pats], term_pos[pats], pattern_valid[pats],
            nv=nv, n_label_keys=n_label_keys, emax=emax, tmax=tmax,
        ))

    return step
