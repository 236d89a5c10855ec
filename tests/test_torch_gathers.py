"""Out-of-range gather indices, port vs the JAX package, on the CPU.

The JAX package reads an index out of range by one of two rules: plain
indexing ``x[i, j]`` wraps a negative index once and clamps it into
range; ``jnp.take_along_axis`` wraps one in ``[-n, 0)`` and reads
``INT32_MIN`` for any other.  ``serving.batch._step_once`` uses both
(the sequence, step key and window reads are plain indexing; the
itemset slot and the pattern-vertex lookups are take_along_axis), the
fused walk's plain version only the second; the flat join works them
out once for all its steps.  Here every indexing field of the step
rows, and the sequence of some cells, is set to -1, -(n+3), n and n+7,
and the port's outputs must be JAX's bit for bit.  The CUDA
kernel is held to the plain version on the same kind of tables by
tests/test_torch_serving_cuda.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_db
from gather_inputs import FIELDS, out_of_range, out_of_range_steps
from repro.kernels.trie_walk import trie_walk_core
from repro.mining.driver import AcceleratedMiner
from repro.mining.encoding import PAD_PHI, PAD_PSI, encode_db
from repro.serving import batch as jb
from repro.serving.bank import compile_bank
from repro.serving.trie import build_trie, pack_subtrees
from repro_torch.kernels import INT32_MIN, gather_index, take_fill
from repro_torch.kernels.trie_walk import ops
from repro_torch.serving import batch

EMAX = 4
jax_walk = jax.jit(trie_walk_core,
                   static_argnames=("emax", "tmax", "ni", "nv"))


@pytest.fixture(scope="module")
def tables():
    """A mined bank and a query batch's token table and inverted index."""
    db = random_db(7, n_seq=8, n_steps=4, n_v=4)
    queries = random_db(8, n_seq=12, n_steps=5, n_v=5)
    bank = compile_bank(AcceleratedMiner(db).mine_rs(2, max_len=4))
    tdb = encode_db(queries)
    order, start, count = (np.asarray(a) for a in jb.build_token_index(
        jnp.asarray(tdb.tokens), n_label_keys=bank.n_label_keys))
    return {"bank": bank, "tokens": np.asarray(tdb.tokens, np.int32),
            "order": order, "start": start, "count": count,
            "tmax": jb.max_key_bucket(tdb.tokens, bank.n_label_keys)}


def test_helpers_match_jax_rules():
    x = np.arange(10, dtype=np.int32).reshape(2, 5) * 3
    idx = np.array([[0, -1, -5, -6, 4, 5, 12, -(2**31)]] * 2, np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx),
                                          axis=1))
    got = take_fill(torch.from_numpy(x), 1, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == INT32_MIN).sum() == 8
    rows = np.array([0, 1, 5, -3, -1, 2], np.int32)
    cols = np.array([9, -1, -9, 2, -6, 4], np.int32)
    want = np.asarray(jnp.asarray(x)[rows, cols])
    got = torch.from_numpy(x)[gather_index(torch.from_numpy(rows), 2),
                              gather_index(torch.from_numpy(cols), 5)]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lead", [(40,), (10, 4)])
def test_step_ranges_match_jax_rules(lead):
    """``_step_ranges`` resolves each index field of [N, 8] or [N, L, 8]
    step rows to the entry JAX reads: the sequence and the step key by
    plain indexing, ``idx`` and ``pu1``/``pu2`` by take_along_axis
    (INT32_MIN out of range), ``prev_phi``'s slot by JAX's clip."""
    n_seq, K, ni, nv = 5, 7, 3, 4
    rng = np.random.default_rng(0)
    vals = np.array([0, 1, -1, -2, 2, 3, 4, 5, 6, 7, -4, -5, -8, -9, 11,
                     2**31 - 1, -(2**31)], np.int32)
    steps = rng.choice(vals, size=(*lead, 8)).astype(np.int32)
    cell_b = rng.choice(vals, size=lead[0]).astype(np.int32)
    got = batch._step_ranges(torch.from_numpy(cell_b),
                             torch.from_numpy(steps), n_seq=n_seq,
                             n_keys=K, ni=ni, nv=nv)
    cb, key, idx, idx_ok, pu, pu_ok, prev = (g.numpy() for g in got)

    def plain(i, n):  # the entry x[i] reads in an axis of n
        return np.asarray(jnp.arange(n)[jnp.asarray(i)])

    def along(i, n):  # take_along_axis into an axis of n
        i = jnp.asarray(i).reshape(-1, 1)
        return np.asarray(jnp.take_along_axis(
            jnp.arange(n, dtype=jnp.int32)[None].repeat(i.shape[0], 0), i,
            axis=1)).reshape(lead)

    np.testing.assert_array_equal(
        cb, np.broadcast_to(plain(cell_b, n_seq).reshape(
            lead[0], *(1,) * (len(lead) - 1)), lead))
    np.testing.assert_array_equal(key, plain(steps[..., 7], K))
    np.testing.assert_array_equal(np.where(idx_ok, idx, INT32_MIN),
                                  along(steps[..., 5], ni))
    for c in (0, 1):
        np.testing.assert_array_equal(
            np.where(pu_ok[..., c], pu[..., c], INT32_MIN),
            along(steps[..., 1 + c], nv))
    np.testing.assert_array_equal(prev, np.asarray(jnp.clip(
        jnp.asarray(steps[..., 5]) - 1, 0, ni - 1)))


def _step_inputs(t, step, fields):
    """Every (query, pattern) cell at one step of the pattern's program,
    its frontier from the steps before (JAX's ``_step_once``), then the
    step rows with ``fields`` out of range and, in the first cells,
    sequence indices of -1, -(B+3), B and B+7."""
    bank = t["bank"]
    B, P = t["tokens"].shape[0], bank.n_patterns
    b, p = np.meshgrid(np.arange(B), np.arange(P), indexing="ij")
    cell_b = b.ravel().astype(np.int32)
    steps = bank.steps[p.ravel()]
    N, L = steps.shape[:2]
    tab = [jnp.asarray(t[k]) for k in ("tokens", "order", "start", "count")]
    phi = jnp.full((N, 1, L), PAD_PHI, jnp.int32)
    psi = jnp.full((N, 1, bank.nv), PAD_PSI, jnp.int32)
    valid = jnp.ones((N, 1), bool)
    for k in range(step):
        phi, psi, valid, _ = jb._step_once(
            *tab, jnp.asarray(cell_b), jnp.asarray(steps[:, k]), phi, psi,
            valid, emax=EMAX, tmax=t["tmax"], use_kernel=False, block_g=64,
            uniform=False, compact=True)
    step_k, n_bad = out_of_range_steps(
        steps[:, step], K=t["start"].shape[1], ni=L, nv=bank.nv,
        fields=fields, every=1 if len(fields) == 1 else 2)
    assert n_bad >= 16
    cell_b = cell_b.copy()
    cell_b[:4] = out_of_range(B)
    return [np.array(a) for a in (*tab, cell_b, step_k, phi, psi, valid)]


@pytest.mark.parametrize("field,step,mode,narrow", [
    ("all", 0, "compact", False), ("all", 1, "compact", True),
    ("idx", 1, "compact", False), ("idx", 1, "terminal", False),
    ("key", 1, "terminal_frontier", True), ("pu1", 1, "compact", False),
    ("pu2", 0, "terminal_frontier", False)])
def test_step_once_out_of_range_matches_jax(tables, field, step, mode,
                                            narrow):
    """One field out of range in every real row, or all of them in turn
    over every other row; a one-token window (``narrow``) makes a step
    key's bucket count show through the window overflow."""
    args = _step_inputs(tables, step,
                        tuple(FIELDS) if field == "all" else (field,))
    kw = dict(emax=EMAX, tmax=1 if narrow else tables["tmax"],
              uniform=False,
              compact=mode == "compact",
              count_frontier_ovf=mode == "terminal_frontier")
    want = jb._step_once(*[jnp.asarray(a) for a in args], use_kernel=False,
                         block_g=64, **kw)
    got = batch._step_once(*[torch.from_numpy(a) for a in args], **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # a step key out of range opens no window of the step's own type and
    # label (clamped, it reads another bucket), so no key row accepts
    accepted = np.asarray(want[-2 if mode == "compact" else 0])
    assert accepted.any() == (field != "key")


@pytest.mark.parametrize("field", ["all", "pu1"])
def test_join_out_of_range_matches_jax(tables, field):
    """The flat join works out the indices of all its steps at once
    (``_step_ranges`` over [N, L, 8]): whole programs with ``field`` out
    of range in every other real row, and some cells' sequences, give
    JAX's containment and overflow flags."""
    t, bank = tables, tables["bank"]
    B, P = t["tokens"].shape[0], bank.n_patterns
    b, p = (a.ravel() for a in np.meshgrid(np.arange(B), np.arange(P),
                                            indexing="ij"))
    steps, n_bad = out_of_range_steps(
        bank.steps[p], K=t["start"].shape[1], ni=bank.steps.shape[1],
        nv=bank.nv, fields=tuple(FIELDS) if field == "all" else (field,),
        every=2)
    assert n_bad >= 16
    cell_b = b.astype(np.int32)
    cell_b[:4] = out_of_range(B)
    args = [t[k] for k in ("tokens", "order", "start", "count")] + [
        cell_b, steps]
    kw = dict(nv=bank.nv, emax=EMAX, tmax=t["tmax"])
    want = jb._join(*[jnp.asarray(a) for a in args], use_kernel=False,
                    block_g=64, **kw)
    got = batch._join(*[torch.from_numpy(np.array(a)) for a in args],
                      **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.asarray(want[0]).any()


def _walk_inputs(seed, field):
    """The per-cell tables of every (query, subtree shard) cell of a
    mined bank, with ``field`` out of range in every real slot, or all
    the indexing fields in turn over every third ("all")."""
    db = random_db(seed, n_seq=8, n_steps=4, n_v=4)
    queries = random_db(seed + 1, n_seq=12, n_steps=5, n_v=5)
    bank = compile_bank(AcceleratedMiner(db).mine_rs(2, max_len=4))
    trie = build_trie(bank)
    pack = pack_subtrees(trie)
    tdb = encode_db(queries)
    order, start, count = (np.asarray(a) for a in jb.build_token_index(
        jnp.asarray(tdb.tokens), n_label_keys=bank.n_label_keys))
    req = pack.pack_req(trie.node_req.reshape(trie.n_nodes, -1))
    b, s = (a.ravel() for a in np.meshgrid(
        np.arange(len(queries)), np.arange(pack.n_subtrees),
        indexing="ij"))
    dims = dict(tmax=jb.max_key_bucket(tdb.tokens, bank.n_label_keys),
                ni=trie.depth, nv=bank.nv)
    fields = tuple(FIELDS) if field == "all" else (field,)
    steps, n_bad = out_of_range_steps(
        pack.steps[s], K=start.shape[1], ni=dims["ni"], nv=dims["nv"],
        fields=fields, every=3 if field == "all" else 1)
    assert n_bad >= 16
    args = [np.asarray(tdb.tokens)[b], order[b], start[b], count[b], steps,
            pack.parent[s], req[s]]
    return [np.ascontiguousarray(a, np.int32) for a in args], dims


@pytest.mark.parametrize("seed,emax,narrow,field", [
    (7, 1, False, "all"), (7, 4, True, "key"), (7, 4, False, "idx"),
    (21, 4, False, "all"), (21, 4, True, "all")])
def test_trie_walk_core_out_of_range_matches_jax(seed, emax, narrow, field):
    """A one-token window (``narrow``): a step key read as INT32_MIN
    opens no window and so raises no window overflow."""
    args, dims = _walk_inputs(seed, field)
    kw = dict(dims, emax=emax)
    if narrow:
        kw["tmax"] = 1
    want = [np.asarray(x) for x in
            jax_walk(*[jnp.asarray(a) for a in args], **kw)]
    got = ops.trie_walk(*[torch.from_numpy(a) for a in args], **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    # a slot whose step key reads INT32_MIN accepts nothing
    assert want[0].any() == (field != "key")
