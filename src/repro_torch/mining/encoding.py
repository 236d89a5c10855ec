"""Dense tensor encoding of transformation-sequence databases.

The device engine operates on fixed-shape int32 tensors:

* ``tokens``   [G, T, 6]  - one row per TR: (type, u1, u2, label, j, valid)
  where ``j`` is the itemset (intrastate) index within its sequence.
* embeddings of the current pattern: ``gid`` [E], ``phi`` [E, NI]
  (data itemset index per pattern itemset, ``PAD_PHI`` beyond n),
  ``psi`` [E, NV] (data vertex per pattern vertex, ``PAD_PSI`` beyond m).

Extension *signatures* pack a candidate one-TR extension in pattern
coordinates into one int64 so that discovery + support counting reduce to
elementwise compares and sort/segment reductions (see engine.py).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..core.enumerate_host import Emb, ExtKey, Slot
from ..core.graphseq import NO_LABEL, NO_VERTEX, Pattern, TR, TRSeq, TRType
from ..kernels import PAD_PHI, PAD_PSI

SENT_V = 15  # pu2 sentinel for vertex TRs inside signatures
INVALID_SIG = np.int32(-1)

# signature bit layout: 31 bits of an int32 (JAX default itype).
# slot_kind(1) | slot_idx(5) | type(3) | pu1(4) | pu2(4) | label+1(14)
# => caps: <=31 pattern itemsets, <=14 pattern vertices, <=16382 labels.
_LAB_BITS = 14
_PU_BITS = 4
_TY_BITS = 3
_SL_BITS = 5


@dataclasses.dataclass
class TokenDB:
    tokens: np.ndarray  # [G, T, 6] int32
    n_itemsets: np.ndarray  # [G] int32
    n_labels: int

    @property
    def n_seq(self) -> int:
        return self.tokens.shape[0]

    @property
    def max_tokens(self) -> int:
        return self.tokens.shape[1]


def encode_db(db: Sequence[TRSeq], pad_to: int | None = None,
              pad_seqs_to: int | None = None) -> TokenDB:
    # one flat row list + a single scatter: serving encodes a fresh
    # batch per cache-miss chunk, so this path is throughput-critical
    flat: List[Tuple[int, ...]] = []
    lens: List[int] = []
    for s in db:
        n0 = len(flat)
        for j, itemset in enumerate(s):
            flat += [tr + (j, 1) for tr in itemset]
        lens.append(len(flat) - n0)
    T = max(lens, default=1)
    if pad_to is not None:
        assert pad_to >= T, (pad_to, T)
        T = pad_to
    G0 = len(db)
    G = G0
    if pad_seqs_to is not None:
        assert pad_seqs_to >= G
        G = pad_seqs_to
    tokens = np.zeros((G, max(T, 1), 6), dtype=np.int32)
    tokens[..., 1] = NO_VERTEX
    tokens[..., 2] = NO_VERTEX
    tokens[..., 3] = NO_LABEL
    if flat:
        arr = np.asarray(flat, dtype=np.int32)
        lens_a = np.asarray(lens)
        off = np.cumsum(lens_a) - lens_a
        idx_g = np.repeat(np.arange(G0), lens_a)
        idx_t = np.arange(len(flat)) - np.repeat(off, lens_a)
        tokens[idx_g, idx_t] = arr
        max_label = int(arr[:, 3].max(initial=0))
    else:
        max_label = 0
    n_itemsets = np.array(
        [len(s) for s in db] + [0] * (G - G0), dtype=np.int32
    )
    assert max_label + 1 < (1 << _LAB_BITS) - 1, "label space too large"
    return TokenDB(tokens=tokens, n_itemsets=n_itemsets,
                   n_labels=max_label + 1)


def encode_embeddings(
    embs: Sequence[Emb], ni: int, nv: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    E = len(embs)
    gid = np.zeros((E,), dtype=np.int32)
    phi = np.full((E, ni), PAD_PHI, dtype=np.int32)
    psi = np.full((E, nv), PAD_PSI, dtype=np.int32)
    for i, (g, ph, ps) in enumerate(embs):
        gid[i] = g
        assert len(ph) <= ni and len(ps) <= nv, (len(ph), len(ps))
        phi[i, : len(ph)] = ph
        for pv, dv in ps:
            psi[i, pv] = dv
    return gid, phi, psi


@dataclasses.dataclass(frozen=True)
class EmbBlock:
    """One pattern's embedding list as the padded int32 rows the scans
    read: ``gid`` [E], ``phi`` [E, NI] (``PAD_PHI`` beyond the pattern's
    itemsets), ``psi`` [E, NV] (``PAD_PSI`` beyond its vertices) - what
    ``encode_embeddings`` gives for the same ``Emb`` list.  The miner's
    work pool holds these, so a rebuilt child's rows go to its next scan
    without passing through Python tuples."""

    gid: np.ndarray
    phi: np.ndarray
    psi: np.ndarray

    def __len__(self) -> int:
        return self.gid.shape[0]

    @classmethod
    def from_embs(cls, embs: Sequence[Emb], ni: int, nv: int) -> "EmbBlock":
        return cls(*encode_embeddings(embs, ni, nv))

    @classmethod
    def root(cls, n_seq: int, ni: int, nv: int) -> "EmbBlock":
        """The empty pattern's embeddings: one unbound row a sequence."""
        return cls(np.arange(n_seq, dtype=np.int32),
                   np.full((n_seq, ni), PAD_PHI, dtype=np.int32),
                   np.full((n_seq, nv), PAD_PSI, dtype=np.int32))

    def to_embs(self) -> List[Emb]:
        """The ``Emb`` tuples these rows encode, ``psi`` as
        ``(pattern vertex, data vertex)`` pairs over the bound vertices
        (a pattern binds its vertices 0..m-1, so the pads are a row's
        tail)."""
        n_phi = int((self.phi != PAD_PHI).sum(axis=1).max(initial=0))
        n_psi = int((self.psi != PAD_PSI).sum(axis=1).max(initial=0))
        return [
            (int(g), tuple(ph), tuple(enumerate(ps)))
            for g, ph, ps in zip(self.gid.tolist(),
                                 self.phi[:, :n_phi].tolist(),
                                 self.psi[:, :n_psi].tolist())
        ]


def encode_pattern_trs(p: Pattern, max_rows: int) -> np.ndarray:
    """[(itemset, type, pu1, pu2, label)] rows, padded with -9."""
    rows = []
    for i, itemset in enumerate(p):
        for tr in itemset:
            pu2 = SENT_V if tr.is_vertex else tr.u2
            rows.append((i, int(tr.type), tr.u1, pu2, tr.label))
    assert len(rows) <= max_rows, (len(rows), max_rows)
    out = np.full((max_rows, 5), -9, dtype=np.int32)
    for i, r in enumerate(rows):
        out[i] = r
    return out


def pack_signature(slot_kind: int, slot_idx: int, ty: int, pu1: int,
                   pu2: int, label: int) -> int:
    """Pure-python mirror of the device packing (for tests/decoding)."""
    assert slot_idx < (1 << _SL_BITS) and pu1 < (1 << _PU_BITS)
    assert pu2 < (1 << _PU_BITS) and label + 1 < (1 << _LAB_BITS)
    lab = label + 1  # NO_LABEL -> 0
    v = slot_kind
    v = (v << _SL_BITS) | slot_idx
    v = (v << _TY_BITS) | ty
    v = (v << _PU_BITS) | pu1
    v = (v << _PU_BITS) | pu2
    v = (v << _LAB_BITS) | lab
    return int(v)


def unpack_signature(sig: int) -> Tuple[int, int, int, int, int, int]:
    lab = sig & ((1 << _LAB_BITS) - 1)
    sig >>= _LAB_BITS
    pu2 = sig & ((1 << _PU_BITS) - 1)
    sig >>= _PU_BITS
    pu1 = sig & ((1 << _PU_BITS) - 1)
    sig >>= _PU_BITS
    ty = sig & ((1 << _TY_BITS) - 1)
    sig >>= _TY_BITS
    slot_idx = sig & ((1 << _SL_BITS) - 1)
    sig >>= _SL_BITS
    return (sig, slot_idx, ty, pu1, pu2, lab - 1)


def signature_to_extkey(sig: int) -> ExtKey:
    slot_kind, slot_idx, ty, pu1, pu2, label = unpack_signature(sig)
    slot: Slot = ("in" if slot_kind == 0 else "gap", slot_idx)
    if pu2 == SENT_V:
        tr = TR(TRType(ty), pu1, NO_VERTEX, label)
    else:
        tr = TR(TRType(ty), pu1, pu2, label)
    return (slot, tr)
