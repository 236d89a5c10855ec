"""Single-host serving, port vs the JAX package, on the CPU: the host
structures (bank, trie, packed subtrees), the token index and
prescreens, the dense joins, and ``PatternServer`` under all three
layouts - rows and counters equal to the JAX server's and to the host
oracle, escalation and host fallback included - plus the Join API and
the launcher.  Inputs are mined from the same seeded DBs in both
packages."""
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import random_db
from repro.core.containment import contains as j_contains
from repro.mining.driver import AcceleratedMiner as JaxMiner
from repro.mining.encoding import encode_db as j_encode_db
from repro.serving import batch as jb
from repro.serving.bank import compile_bank as j_compile_bank
from repro.serving.bank import extend_bank as j_extend_bank
from repro.serving.bank import sequence_fingerprint as j_fingerprint
from repro.serving.join import Frontend as JFrontend
from repro.serving.join import JoinRequest as JJoinRequest
from repro.serving.server import PatternServer as JServer
from repro.serving.trie import build_trie as j_build_trie
from repro.serving.trie import extend_trie as j_extend_trie
from repro.serving.trie import masked_node_req as j_masked_node_req
from repro.serving.trie import pack_subtrees as j_pack_subtrees

from repro_torch.core.containment import contains
from repro_torch.core.graphseq import db_from_reference, pattern_key
from repro_torch.launch import serve
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.mining.encoding import encode_db
from repro_torch.serving import batch
from repro_torch.serving.bank import (
    bank_from_reference,
    compile_bank,
    extend_bank,
    sequence_fingerprint,
)
from repro_torch.serving.join import Frontend, JoinRequest
from repro_torch.serving.server import PatternServer, encode_queries
from repro_torch.serving.trie import (
    build_trie,
    extend_trie,
    masked_node_req,
    pack_subtrees,
)

LAYOUTS = ("flat", "trie", "trie_fused")
BANK_ARRAYS = ("steps", "support", "n_steps", "n_itemsets", "n_vertices",
               "pattern_valid", "req")


@pytest.fixture(scope="module")
def served():
    """One DB mined by both packages, the JAX bank and its port, the
    query batch in both packages' types and the host oracle's rows."""
    jdb = random_db(3, n_seq=8, n_steps=4, n_v=4)
    jq = random_db(4, n_seq=12, n_steps=5, n_v=5)
    jres = JaxMiner(jdb).mine_rs(2, max_len=4)
    tres = AcceleratedMiner(db_from_reference(jdb),
                            device="cpu").mine_rs(2, max_len=4)
    jbank = j_compile_bank(jres)
    want = np.array([[j_contains(p, s) for p in jbank.patterns] for s in jq])
    return {
        "jdb": jdb, "jq": jq, "tq": db_from_reference(jq), "jres": jres,
        "tres": tres, "jbank": jbank, "tbank": bank_from_reference(jbank),
        "want": want,
    }


def _assert_bank_equal(tbank, jbank):
    for name in BANK_ARRAYS:
        np.testing.assert_array_equal(getattr(tbank, name),
                                      getattr(jbank, name), err_msg=name)
    assert (tbank.nv, tbank.n_label_keys) == (jbank.nv, jbank.n_label_keys)
    assert [pattern_key(p) for p in tbank.patterns] == \
        [pattern_key(p) for p in jbank.patterns]


def _assert_trie_equal(tt, jt):
    for name in ("node_step", "node_parent", "node_depth", "node_req",
                 "terminal_node", "node_pos"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name),
                                      err_msg=name)
    assert len(tt.levels) == len(jt.levels)
    for a, b in zip(tt.levels, jt.levels):
        np.testing.assert_array_equal(a, b)


def test_bank_trie_and_pack_equal_jax(served):
    """The port compiles its own mined map into the very arrays the JAX
    package compiles (bank, trie, packed subtrees, masked prescreen
    rows), and bank_from_reference carries the JAX bank across."""
    jbank = served["jbank"]
    tbank = compile_bank(served["tres"])
    _assert_bank_equal(tbank, jbank)
    _assert_bank_equal(served["tbank"], jbank)
    tt, jt = build_trie(tbank), j_build_trie(jbank)
    _assert_trie_equal(tt, jt)
    tp, jp = pack_subtrees(tt), j_pack_subtrees(jt)
    for name in ("node_ids", "steps", "parent", "roots", "term_sub",
                 "term_slot", "term_rows", "term_nodes", "leaf_rows",
                 "leaf_roots"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name),
                                      err_msg=name)
    active = np.random.default_rng(0).random(jbank.n_patterns) < 0.6
    nreq = masked_node_req(tt, active)
    np.testing.assert_array_equal(nreq, j_masked_node_req(jt, active))
    np.testing.assert_array_equal(tp.pack_req(nreq), jp.pack_req(nreq))
    # an incremental extension equals the JAX package's too
    items = sorted(served["tres"].patterns.items(),
                   key=lambda ps: pattern_key(ps[0]))
    jitems = sorted(served["jres"].patterns.items(),
                    key=lambda ps: pattern_key(ps[0]))
    half = len(items) // 2
    tb0, jb0 = compile_bank(dict(items[:half])), \
        j_compile_bank(dict(jitems[:half]))
    tb1 = extend_bank(tb0, dict(items[half:]))
    jb1 = j_extend_bank(jb0, dict(jitems[half:]))
    _assert_bank_equal(tb1, jb1)
    _assert_trie_equal(extend_trie(build_trie(tb0), tb1),
                       j_extend_trie(j_build_trie(jb0), jb1))


def test_token_index_and_prescreens_equal_jax(served):
    bank = served["tbank"]
    NL = bank.n_label_keys
    tokens = j_encode_db(served["jq"], pad_to=16, pad_seqs_to=16).tokens
    np.testing.assert_array_equal(encode_db(served["tq"], pad_to=16,
                                            pad_seqs_to=16).tokens, tokens)
    want = [np.asarray(a) for a in jb.index_and_prescreen(
        jnp.asarray(tokens), jnp.asarray(bank.req), n_label_keys=NL)]
    t = torch.from_numpy(tokens)
    got = batch.index_and_prescreen(t, torch.from_numpy(bank.req),
                                    n_label_keys=NL)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    for g, w in zip(batch.build_token_index(t, n_label_keys=NL), want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(batch.token_counts_np(tokens, NL), want[2])
    np.testing.assert_array_equal(
        batch.prescreen_counts(t, torch.from_numpy(bank.req),
                               n_label_keys=NL).numpy(), want[3])
    nreq = build_trie(bank).node_req
    jn = jb.index_and_node_prescreen(jnp.asarray(tokens), jnp.asarray(nreq),
                                     n_label_keys=NL)
    tn = batch.index_and_node_prescreen(t, torch.from_numpy(nreq),
                                        n_label_keys=NL)
    np.testing.assert_array_equal(tn[3].numpy(), np.asarray(jn[3]))
    assert batch.max_key_bucket(tokens, NL) == jb.max_key_bucket(tokens, NL)


def test_dense_joins_equal_jax(served):
    """batch_contains / trie_contains / pair_contains give the JAX
    package's contained AND overflow bits, at a frontier capacity of 2
    that overflows."""
    emax = 2
    bank = served["tbank"]
    tokens = j_encode_db(served["jq"]).tokens
    kw = dict(nv=bank.nv, n_label_keys=bank.n_label_keys, emax=emax,
              tmax=jb.max_key_bucket(tokens, bank.n_label_keys))
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens)
    want = jb.batch_contains(jt, jnp.asarray(bank.steps),
                                 jnp.asarray(bank.pattern_valid), **kw)
    got = batch.batch_contains_ref(tt, torch.from_numpy(bank.steps),
                                   torch.from_numpy(bank.pattern_valid), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    c = np.asarray(want[0])
    assert not (c & ~served["want"]).any()  # contained is always exact
    assert np.asarray(want[1]).any()
    lv = build_trie(bank).padded_levels()
    targs = [torch.from_numpy(a) for a in
             (lv.steps, lv.parent_pos, lv.term_level, lv.term_pos,
              bank.pattern_valid)]
    got_t = batch.trie_contains_ref(tt, *targs, **kw)
    for g, w in zip(got_t, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    b_idx, p_idx = np.nonzero(np.ones_like(c))
    bi, pi = b_idx.astype(np.int32), p_idx.astype(np.int32)
    got_p = batch.pair_contains(tt, torch.from_numpy(bank.steps),
                                torch.from_numpy(bi), torch.from_numpy(pi),
                                **kw)
    want_p = jb.pair_contains(jt, jnp.asarray(bank.steps), jnp.asarray(bi),
                              jnp.asarray(pi), **kw)
    for g, w in zip(got_p, want_p):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


COUNTERS = ("queries", "cache_hits", "device_batches", "pairs_possible",
            "pairs_prescreened", "cells_possible", "cells_prescreened",
            "joined_steps", "escalated_cells", "host_fallback_cells")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("emax,emax_retry", [(4, 16), (1, 2)])
def test_server_rows_and_counters_equal_jax(served, layout, emax,
                                            emax_retry):
    """PatternServer rows equal the JAX server's and the host oracle
    under every layout; frontier capacity 1 forces escalation (to a
    retry capacity of 2) and then host fallback, and every counter
    matches.  A tombstone
    mask then gives the JAX server's masked rows."""
    kw = dict(emax=emax, emax_retry=emax_retry, max_batch=16,
              bank_layout=layout)
    js = JServer(served["jbank"], **kw)
    ts = PatternServer(served["tbank"], device="cpu", **kw)
    for _ in range(2):  # the second pass is cache-served
        jr = [r.contained for r in js.query(served["jq"])]
        tr = [r.contained for r in ts.query(served["tq"])]
        np.testing.assert_array_equal(np.stack(tr), np.stack(jr))
        np.testing.assert_array_equal(np.stack(tr), served["want"])
    assert {k: ts.stats[k] for k in COUNTERS} == \
        {k: js.stats[k] for k in COUNTERS}
    if emax == 1:
        assert ts.stats["escalated_cells"] > 0
        assert ts.stats["host_fallback_cells"] > 0
    active = np.arange(served["jbank"].n_patterns) % 3 != 0
    js.set_row_mask(active)
    ts.set_row_mask(active)
    np.testing.assert_array_equal(ts.exact_rows(served["tq"]),
                                  js.exact_rows(served["jq"]))


def test_join_api_and_frontend_equal_jax(served):
    """Frontend/JoinRequest: sync, async begin/finish and the
    approximate tier give the JAX package's rows and top-k."""
    js = JServer(served["jbank"], bank_layout="trie_fused", max_batch=16)
    ts = PatternServer(served["tbank"], bank_layout="trie_fused",
                       max_batch=16, device="cpu")
    jf, tf = JFrontend(js), Frontend(ts)
    for exact in (True, False):
        jr = jf.join(JJoinRequest(seqs=served["jq"], k=3, exact=exact))
        tr = tf.join(JoinRequest(seqs=served["tq"], k=3, exact=exact))
        np.testing.assert_array_equal(tr.rows, jr.rows)
        assert tr.exact == jr.exact == exact
        assert [r.topk for r in tr.results] == [r.topk for r in jr.results]
    got = tf.finish(tf.begin(JoinRequest(seqs=served["tq"])))
    np.testing.assert_array_equal(got.rows, served["want"])
    assert not (served["want"] & ~ts.approx_rows(served["tq"])).any()


def test_shared_encoding_and_fingerprints(served):
    """A launch from a shared encoding gives the same rows as one that
    encodes its own batch, and the fingerprints (the cache keys) are the
    JAX package's."""
    ts = PatternServer(served["tbank"], bank_layout="flat", device="cpu")
    shared = encode_queries(served["tq"], device="cpu",
                            n_label_keys=served["tbank"].n_label_keys)
    got = ts.finalize_rows(ts.launch_rows(served["tq"], shared=shared))
    np.testing.assert_array_equal(got, served["want"])
    assert [sequence_fingerprint(s) for s in served["tq"]] == \
        [j_fingerprint(s) for s in served["jq"]]


def test_oracle_equals_jax(served):
    """The port's host oracle (the server's last rung) is the JAX
    package's."""
    bank = served["tbank"]
    got = np.array([[contains(p, s) for p in bank.patterns]
                    for s in served["tq"]])
    np.testing.assert_array_equal(got, served["want"])


def test_device_defaults_to_cuda(served):
    """With no device given the server runs on cuda, and raises where
    there is none instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert PatternServer(served["tbank"]).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PatternServer(served["tbank"])


def test_serve_launcher_on_cpu(monkeypatch, capsys):
    """The launcher serves and verifies on the CPU, and refuses the
    modes that are not ported yet instead of falling back."""
    base = ["serve", "--device", "cpu", "--db-size", "16", "--queries",
            "16", "--emax", "1", "--bank-layout", "trie_fused"]
    monkeypatch.setattr(sys, "argv", base)
    serve.main()
    assert "(verified)" in capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", base + ["--window", "10"])
    with pytest.raises(SystemExit) as exc:
        serve.main()
    assert exc.value.code != 0
    assert "not ported yet" in capsys.readouterr().err
