"""Distributed extension scans over a ``torch.distributed`` device mesh.

Sharding layout (meshes from launch/mesh.py):

* DB token tensor [G, T, 6] - sequences sharded over ("pod","data")
  (disjoint gid ranges per shard), tokens sharded over "model" (the match
  compute is embarrassingly parallel over tokens).
* embeddings [E, ...]       - co-sharded with their gid's DB shard.
* output: a replicated candidate table (uniq signatures [k] + distinct-gid
  supports [k]).

Collective schedule (the whole cross-rank traffic of one scan):

1. all_gather over "model" - of each token shard's deduplicated
   (sig, gid) pair table (``prededup=True``, k pairs per shard), or of
   the int32 signature matrix, reassembling each data shard's full
   [E_loc, T] matrix (``prededup=False``).
2. local sort + segment reduction -> per-shard (sig, count) table, exact
   because gid ranges are disjoint.
3. all_gather of the [k] tables over ("pod","data") + a local
   merge-by-signature, and a MAX all_reduce of ``n_distinct`` over the
   same ranks.

Every rank is handed the same global tensors and takes its own block by
its mesh coordinates, as ``shard_map``'s input specs cut them in the JAX
package; the step is then one SPMD program: every rank calls it with the
same arguments in the same order.  Each rank's scan is the match_count
kernel on a CUDA mesh (its plain version on a CPU mesh).  The tables'
sort and segment sums are plain tensor ops, as in the JAX package,
where they run outside its Pallas kernel.  With ``k`` too small the
tables are cut as the JAX package cuts them (``n_distinct > k`` tells
the caller to re-run with a larger ``k``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..collectives import (
    all_gather,
    axes_group,
    axes_index,
    check_device,
    rank_device,
    shard_block,
)
from .encoding import INVALID_SIG
from .engine import (
    _lexsort_pairs,
    _pair_table,
    _row_pairs,
    _shifted,
    match_signatures,
    merge_tables,
)


def _dedup_pairs(flat_sig, flat_gid, kp: int):
    """Unique (sig, gid) pairs, fixed size kp (pads sig=-1, gid=-1)."""
    order = _lexsort_pairs(flat_sig, flat_gid)
    ss, gg = flat_sig[order], flat_gid[order]
    keep = ((ss != _shifted(ss, -7)) | (gg != _shifted(gg, -7))) & (ss >= 0)
    # stable compaction into kp slots + one dump slot for drops/overflow
    pos = torch.cumsum(keep, 0) - 1
    idx = torch.where(keep & (pos < kp), pos, kp)
    out_s = torch.full((kp + 1,), int(INVALID_SIG), dtype=ss.dtype,
                       device=ss.device)
    out_g = torch.full((kp + 1,), -1, dtype=gg.dtype, device=gg.device)
    out_s[idx] = torch.where(keep, ss, int(INVALID_SIG))
    out_g[idx] = torch.where(keep, gg, -1)
    n_pairs = keep.sum()  # caller checks n_pairs <= kp (else re-run)
    return out_s[:kp], out_g[:kp], n_pairs


def _local_candidate_table(sigs, gid_global, k: int):
    """Exact per-shard (sig -> distinct-gid count) via sort + segments."""
    return _pair_table(*_row_pairs(sigs, gid_global), k)


def _flat_candidate_table(flat_sig, flat_gid, k: int):
    """(sig -> distinct-gid count) over flat pair arrays (may contain
    duplicate pairs, e.g. after a cross-token-shard merge)."""
    return _pair_table(flat_sig, flat_gid, k, gid_pads=True)


def _merge_tables(sig_tables, cnt_tables, k: int):
    """[S,k] tables -> merged [k] table (counts add: disjoint gids)."""
    return merge_tables(list(sig_tables), list(cnt_tables), k)


def make_mining_step(
    mesh: DeviceMesh,
    k: int = 4096,
    db_axes: Tuple[str, ...] = ("data",),
    tok_axis: str = "model",
    prededup: bool = True,
):
    """Build the SPMD extension-scan step over ``mesh``.

    Returns ``step(tokens, gid, phi, psi, valid, existing, nv, n_pat,
    mode) -> (uniq [k], counts [k], n_distinct)``, int32 tensors on this
    rank's device, equal on every rank.  Every rank passes the same
    global tensors, on the mesh's device type: rows of tokens, gid, phi,
    psi and valid are split over ``db_axes`` (row-major), token columns
    over ``tok_axis``; ``existing`` and the scalars are shared.  ``gid``
    must hold *local* indices into the rank's DB shard.

    ``prededup=True`` dedups (sig, gid) pairs per token shard *before*
    the "model"-axis gather: collective bytes drop from E*T*4 to k*8 per
    shard.  Every rank must build the step at the same point (the group
    over several ``db_axes`` is created here)."""
    db_axes = tuple(db_axes)
    db_group = axes_group(mesh, db_axes)
    tok_group = mesh.get_group(tok_axis)
    device = rank_device(mesh)

    def step(tokens, gid, phi, psi, valid, existing, nv, n_pat, mode):
        check_device(device, tokens=tokens, gid=gid, phi=phi, psi=psi,
                     valid=valid, existing=existing)
        shard, n_db = axes_index(mesh, db_axes)
        tok_i, n_tok = axes_index(mesh, (tok_axis,))
        G, T = tokens.shape[:2]
        rows = shard_block(gid.shape[0], n_db, shard, "embedding rows")
        tok = tokens[shard_block(G, n_db, shard, "sequences"),
                     shard_block(T, n_tok, tok_i, "tokens")].contiguous()
        gid = gid[rows]
        sigs = match_signatures(tok, gid, phi[rows], psi[rows],
                                valid[rows], existing, nv, n_pat, mode)
        # global gid offset for this data shard
        gid_global = gid + shard * tok.shape[0]

        if prededup:
            # 1) dedup local pairs, gather only the k-sized pair tables
            ps, pg, _ = _dedup_pairs(*_row_pairs(sigs, gid_global), k)
            # may contain cross-shard dups
            uniq, counts, n_distinct = _flat_candidate_table(
                torch.cat(all_gather(ps, tok_group)),
                torch.cat(all_gather(pg, tok_group)), k)
        else:
            # 1) reassemble each data shard's full signature matrix (the
            # column order is the group's; the table does not depend on
            # it)
            sigs = torch.cat(all_gather(sigs, tok_group), dim=1)
            uniq, counts, n_distinct = _local_candidate_table(
                sigs, gid_global, k)
        # 2) merge candidate tables across DB shards
        uniq, counts = _merge_tables(
            torch.stack(all_gather(uniq, db_group)),
            torch.stack(all_gather(counts, db_group)), k)
        dist.all_reduce(n_distinct, op=dist.ReduceOp.MAX, group=db_group)
        return uniq, counts, n_distinct

    return step
