"""Shared pattern-growth machinery (host reference implementation).

Both the GTRACE baseline and GTRACE-RS grow a pattern by one TR per step
and need, for the current pattern, the set of *extensions* observed in the
database together with their supports and occurrence lists.  This module
implements that discovery from explicit embedding (occurrence) lists --
the pattern-growth analogue of gSpan's rightmost-extension scan and of the
paper's ``Subprocedure`` DB scan (Fig. 11, lines 2-4).

An embedding of pattern ``p`` in data sequence ``gid`` is
``(gid, phi, psi)`` where ``phi`` maps pattern itemset index -> data
itemset index (strictly increasing) and ``psi`` maps pattern vertex ->
data vertex (injective).  Extending ``p`` by inserting a TR at a *slot*
(either joining existing itemset ``i`` or forming a new itemset at gap
``g``) corresponds 1:1 to extending an embedding by one matching data TR,
which makes the enumeration complete (any embedding of the child restricts
to an embedding of the parent).

The device engine in ``repro_torch.mining`` vectorizes exactly this computation;
tests assert bit-identical supports against this module.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, FrozenSet, List, Sequence, Tuple

from .graphseq import (
    NO_VERTEX,
    Pattern,
    TR,
    TRSeq,
    pattern_vertices,
)

# (gid, phi, psi) with psi as a sorted tuple of (pat_v, dat_v) pairs
Emb = Tuple[int, Tuple[int, ...], Tuple[Tuple[int, int], ...]]
# slot: ("in", itemset_index) or ("gap", gap_index in 0..n)
Slot = Tuple[str, int]
ExtKey = Tuple[Slot, TR]


def root_embeddings(db: Sequence[TRSeq]) -> List[Emb]:
    return [(gid, (), ()) for gid in range(len(db))]


@dataclass
class Extension:
    key: ExtKey
    gids: set = field(default_factory=set)
    embeddings: List[Emb] = field(default_factory=list)

    @property
    def support(self) -> int:
        return len(self.gids)


def _insert_slot(phi: Tuple[int, ...], slot: Slot, di: int) -> Tuple[int, ...]:
    kind, idx = slot
    if kind == "in":
        return phi
    return phi[:idx] + (di,) + phi[idx:]


def find_extensions(
    pattern: Pattern,
    embeddings: Sequence[Emb],
    db: Sequence[TRSeq],
    allow: Callable[[Slot, TR], bool],
    tail_only: bool = False,
) -> Dict[ExtKey, Extension]:
    """Scan the DB (via occurrence lists) for one-TR extensions.

    ``allow(slot, tr_in_pattern_coords)`` filters candidate classes (the
    reverse-search phases or the baseline's unrestricted growth).
    ``tail_only`` restricts slots to PrefixSpan-style tail growth: join the
    last itemset or append a new last itemset.
    """
    n = len(pattern)
    nv = len(pattern_vertices(pattern))
    out: Dict[ExtKey, Extension] = {}

    for gid, phi, psi_t in embeddings:
        seq = db[gid]
        psi = dict(psi_t)
        inv = {dv: pv for pv, dv in psi.items()}
        used_data_v = set(inv.keys())
        pos_of_di = {di: i for i, di in enumerate(phi)}
        last_di = phi[-1] if phi else -1

        for di, data_itemset in enumerate(seq):
            # which slot does this data itemset correspond to?
            if di in pos_of_di:
                slot: Slot = ("in", pos_of_di[di])
            else:
                # find gap index: number of phi entries < di
                g = 0
                while g < n and phi[g] < di:
                    g += 1
                slot = ("gap", g)
            if tail_only:
                if slot[0] == "in" and slot[1] != n - 1:
                    continue
                if slot[0] == "gap" and slot[1] != n:
                    continue
                if slot[0] == "gap" and di <= last_di:
                    continue

            for dtr in data_itemset:
                # map the data TR into pattern coordinates
                if dtr.is_vertex:
                    if dtr.u1 in inv:
                        ptr = TR(dtr.type, inv[dtr.u1], NO_VERTEX, dtr.label)
                        fresh: Tuple[Tuple[int, int], ...] = ()
                    else:
                        ptr = TR(dtr.type, nv, NO_VERTEX, dtr.label)
                        fresh = ((nv, dtr.u1),)
                else:
                    a_in, b_in = dtr.u1 in inv, dtr.u2 in inv
                    if a_in and b_in:
                        pa, pb = inv[dtr.u1], inv[dtr.u2]
                        if pa > pb:
                            pa, pb = pb, pa
                        ptr = TR(dtr.type, pa, pb, dtr.label)
                        fresh = ()
                    elif a_in:
                        ptr = TR(dtr.type, min(inv[dtr.u1], nv),
                                 max(inv[dtr.u1], nv), dtr.label)
                        fresh = ((nv, dtr.u2),)
                    elif b_in:
                        ptr = TR(dtr.type, min(inv[dtr.u2], nv),
                                 max(inv[dtr.u2], nv), dtr.label)
                        fresh = ((nv, dtr.u1),)
                    else:
                        # both endpoints fresh (disconnected edge)
                        ptr = TR(dtr.type, nv, nv + 1, dtr.label)
                        fresh = ((nv, dtr.u1), (nv + 1, dtr.u2))
                # injectivity: fresh data vertices must be unused
                if any(dv in used_data_v for _, dv in fresh):
                    continue
                if len(fresh) == 2 and fresh[0][1] == fresh[1][1]:
                    continue
                # no duplicate TR within an itemset (sets collapse)
                if slot[0] == "in" and ptr in pattern[slot[1]]:
                    continue
                if not allow(slot, ptr):
                    continue
                key = (slot, ptr)
                ext = out.get(key)
                if ext is None:
                    ext = out[key] = Extension(key)
                ext.gids.add(gid)
                new_phi = _insert_slot(phi, slot, di)
                new_psi = tuple(sorted(psi_t + fresh))
                ext.embeddings.append((gid, new_phi, new_psi))
    return out


def merge_extensions_by_canonical(
    pattern: Pattern,
    exts: Dict[ExtKey, Extension],
) -> Dict[Pattern, Tuple[set, List[Emb]]]:
    """Group raw extension keys by the canonical class of their child.

    When the parent has automorphisms, isomorphic raw children (e.g. a
    vertex TR attached to either endpoint of a symmetric edge) are
    distinct keys each carrying only part of the occurrence list; supports
    and embeddings must be merged *before* thresholding or patterns at the
    support boundary are lost.
    """
    from .canonical import canonical_form, canonical_map

    out: Dict[Pattern, Tuple[set, List[Emb]]] = {}
    embsets: Dict[Pattern, set] = {}
    for key, ext in exts.items():
        child_raw = apply_extension(pattern, key)
        child = canonical_form(child_raw)
        vmap = canonical_map(child_raw)
        if child not in out:
            out[child] = (set(), [])
            embsets[child] = set()
        gids, embs = out[child]
        gids |= ext.gids
        es = embsets[child]
        for e in ext.embeddings:
            r = remap_embedding(e, vmap)
            if r not in es:
                es.add(r)
                embs.append(r)
    return out


def apply_extension(pattern: Pattern, key: ExtKey) -> Pattern:
    """Insert the extension's TR into the pattern at its slot."""
    (kind, idx), tr = key
    if kind == "in":
        return tuple(
            (s | {tr}) if i == idx else s for i, s in enumerate(pattern)
        )
    return pattern[:idx] + (frozenset({tr}),) + pattern[idx:]


def remap_embedding(emb: Emb, vmap: Dict[int, int]) -> Emb:
    gid, phi, psi = emb
    return (gid, phi, tuple(sorted((vmap[pv], dv) for pv, dv in psi)))
