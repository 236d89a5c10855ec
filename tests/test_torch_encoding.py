"""The port's copies of the data model, generators and encoding vs the
JAX package's: same seeds give the same DBs, and the encoded arrays
are equal."""
import random

import numpy as np
import pytest
try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: seeded-sampling fallback
    from hypothesis_compat import given, settings, strategies as st

import repro.data.synthetic as jsyn
import repro.mining.encoding as jenc
from conftest import random_db
from repro.core.compile import compile_sequence as j_compile
from repro.core.reverse_search import mine_gtrace_rs as j_mine_rs

import repro_torch.data.synthetic as tsyn
import repro_torch.mining.encoding as tenc
from repro_torch.core.compile import compile_sequence as t_compile
from repro_torch.core.graphseq import TR, TRType, db_from_reference, \
    pattern_key
from repro_torch.core.reverse_search import mine_gtrace_rs as t_mine_rs


def _plain_db(db):
    """A DB as nested tuples of plain ints, itemset order kept."""
    return tuple(
        tuple(tuple(tuple(int(x) for x in tr) for tr in itemset)
              for itemset in seq)
        for seq in db
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_table3_db_same_for_same_seed(seed):
    jp = jsyn.Table3Params(db_size=20, v_avg=5, n_interstates=4)
    tp = tsyn.Table3Params(db_size=20, v_avg=5, n_interstates=4)
    jdb = jsyn.generate_table3_db(jp, seed=seed)
    tdb = tsyn.generate_table3_db(tp, seed=seed)
    assert _plain_db(jdb) == _plain_db(tdb)
    # rebuilt in the port's own classes, the reference DB is the port's
    rebuilt = db_from_reference(jdb)
    assert rebuilt == tdb
    assert all(type(tr) is TR and type(tr.type) is TRType
               for seq in rebuilt for itemset in seq for tr in itemset)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_random_graph_sequence_same_for_same_seed(seed):
    kw = dict(n_steps=4, n_v=4, n_vl=2, n_el=2)
    jg = jsyn.random_graph_sequence(random.Random(seed), **kw)
    tg = tsyn.random_graph_sequence(random.Random(seed), **kw)
    assert [(g.vlabels, g.elabels) for g in jg] == \
        [(g.vlabels, g.elabels) for g in tg]
    assert _plain_db([j_compile(jg)]) == _plain_db([t_compile(tg)])


def test_encode_db_and_embeddings_equal():
    for name in ("PAD_PHI", "PAD_PSI", "INVALID_SIG"):
        a, b = getattr(jenc, name), getattr(tenc, name)
        assert a == b and a.dtype == b.dtype == np.int32
    assert jenc.SENT_V == tenc.SENT_V
    jdb = random_db(4, n_seq=8, n_steps=5, n_v=5)
    tdb = db_from_reference(jdb)
    je, te = jenc.encode_db(jdb), tenc.encode_db(tdb)
    assert np.array_equal(je.tokens, te.tokens)
    assert np.array_equal(je.n_itemsets, te.n_itemsets)
    assert je.n_labels == te.n_labels
    jp = jenc.encode_db(jdb, pad_to=40, pad_seqs_to=11)
    tp = tenc.encode_db(tdb, pad_to=40, pad_seqs_to=11)
    assert np.array_equal(jp.tokens, tp.tokens)
    embs = [(1, (0, 2), ((0, 3), (1, 1))), (4, (1,), ((0, 0),)),
            (7, (), ())]
    for a, b in zip(jenc.encode_embeddings(embs, 16, 12),
                    tenc.encode_embeddings(embs, 16, 12)):
        assert a.dtype == b.dtype == np.int32
        assert np.array_equal(a, b)


def test_encode_pattern_trs_equal():
    """Patterns mined by both packages encode to equal existing tables,
    and their plain keys agree."""
    jdb = random_db(8, n_seq=6, n_steps=4, n_v=4)
    jres = j_mine_rs(jdb, 2, max_len=3)
    tres = t_mine_rs(db_from_reference(jdb), 2, max_len=3)
    jmap = {pattern_key(p): s for p, s in jres.patterns.items()}
    tmap = {pattern_key(p): s for p, s in tres.patterns.items()}
    assert jmap == tmap and len(jmap) > 3
    by_key = {pattern_key(q): q for q in tres.patterns}
    for p in jres.patterns:
        assert np.array_equal(jenc.encode_pattern_trs(p, 64),
                              tenc.encode_pattern_trs(by_key[pattern_key(p)],
                                                      64))


def test_pattern_key_is_plain_and_order_free():
    p = (frozenset({TR(TRType.VI, 0, -1, 1), TR(TRType.EI, 0, 1, 0)}),
         frozenset({TR(TRType.VD, 1, -1, -1)}))
    k = pattern_key(p)
    assert k == (((0, 0, -1, 1), (3, 0, 1, 0)), ((1, 1, -1, -1),))
    assert all(type(x) is int for s in k for tr in s for x in tr)


@settings(max_examples=10, deadline=None)
@given(
    slot_kind=st.integers(0, 1),
    slot_idx=st.integers(0, 15),
    ty=st.integers(0, 5),
    pu1=st.integers(0, 13),
    pu2=st.integers(0, 15),
    label=st.integers(-1, 1000),
)
def test_signature_roundtrip(slot_kind, slot_idx, ty, pu1, pu2, label):
    sig = tenc.pack_signature(slot_kind, slot_idx, ty, pu1, pu2, label)
    assert sig == jenc.pack_signature(slot_kind, slot_idx, ty, pu1, pu2,
                                      label)
    assert 0 <= sig < 2**31
    assert tenc.unpack_signature(sig) == \
        (slot_kind, slot_idx, ty, pu1, pu2, label)
    assert pattern_key([[tenc.signature_to_extkey(sig)[1]]]) == \
        pattern_key([[jenc.signature_to_extkey(sig)[1]]])
