"""The port's BERT4Rec against the JAX package on the CPU, from JAX's init
converted (``models.convert``): ``encode``, the sampled-softmax
``masked_item_loss`` and its grads within 1e-4; ``chunked_topk_scores``
and ``serve_scores``: the same ids and scores within 1e-5 on inputs
without ties; ``examples/recsys_patterns.py``'s chain (mine, serve,
EmbeddingBag, chunked top-k) at the example's own demo config: the same
feature matrix and top-k ids; and the vocab-sharded serve on a gloo
world of 8 ranks (4 data x 2 model) against JAX's on 8 virtual CPU
devices."""
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.recsys import session_batches
from repro.models import bert4rec as jb4r

from repro_torch.core.graphseq import pattern_key
from repro_torch.models import bert4rec as tb4r
from repro_torch.models.common import path_str, tree_leaves_with_path, \
    value_and_grad
from repro_torch.models.convert import params_from_numpy, tree_from_numpy
import torch_family_checks as fc
from torch_dist_worker import recsys_serve_job, run_world

TOL, TOPK_TOL = 1e-4, 1e-5
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples",
                       "recsys_patterns.py")


def _cfgs(**kw):
    kw = dict(dict(name="b", n_items=300, seq_len=16, n_masked=4,
                   n_negatives=32, v_chunk=64, topk=7), **kw)
    return jb4r.Bert4RecConfig(**kw), tb4r.Bert4RecConfig(**kw)


def _params(jc, tc, seed=0):
    jp = jb4r.init_params(jax.random.PRNGKey(seed), jc)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), tc)


def test_config_and_tree():
    jc, tc = _cfgs()
    assert (tc.vocab, tc.mask_id) == (jc.vocab, jc.mask_id) == (302, 301)
    jp, model = _params(jc, tc)
    assert {path_str(p): tuple(x.shape) for p, x in
            tree_leaves_with_path(tb4r.abstract_params(tc))} == \
        {path_str(p): x.shape for p, x in
         tree_leaves_with_path(jax.tree.map(np.asarray, jp))}
    assert "blocks.wqkv" in dict(model.named_parameters())


def test_encode_loss_grads():
    """Cloze batches of ``session_batches`` (padding, MASK tokens, gold
    ids 0 at padded masked positions)."""
    jc, tc = _cfgs()
    jp, model = _params(jc, tc)
    batch = next(session_batches(3, jc.n_items, 6, jc.seq_len, jc.n_masked,
                                 jc.mask_id, jc.n_negatives))
    assert (batch["seq"] == 0).any() and (batch["seq"] == jc.mask_id).any()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = tree_from_numpy(batch)
    np.testing.assert_allclose(
        model(tbatch["seq"]).detach().numpy(),
        np.asarray(jb4r.encode(jp, jbatch["seq"], jc)), rtol=TOL, atol=TOL)
    jl, jg = jax.value_and_grad(jb4r.masked_item_loss)(jp, jbatch, jc)
    tl, tg = value_and_grad(tb4r.masked_item_loss)(model.tree(), tbatch, tc)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL, atol=TOL)
    want = {path_str(p): v for p, v in
            tree_leaves_with_path(jax.tree.map(np.asarray, jg))}
    for p, v in tree_leaves_with_path(tg):
        np.testing.assert_allclose(v.numpy(), want[path_str(p)], rtol=TOL,
                                   atol=TOL, err_msg=path_str(p))


@pytest.mark.parametrize("n_items,v_chunk,topk", [
    (1000, 128, 17),   # the JAX test's config: 1001 rows, a ragged chunk
    (255, 64, 5),      # the chunks divide the 256 scored rows
    (40, 64, 9),       # one chunk, wider than the catalog
])
def test_chunked_topk_and_serve(n_items, v_chunk, topk):
    jc, tc = _cfgs(n_items=n_items, v_chunk=v_chunk, topk=topk)
    jp, model = _params(jc, tc, seed=1)
    tp = model.tree()
    q = np.random.default_rng(2).normal(size=(5, jc.d_model)).astype(
        np.float32)
    js, ji = jb4r.chunked_topk_scores(jp, jnp.asarray(q), jc)
    with torch.no_grad():
        ts, ti = tb4r.chunked_topk_scores(tp, torch.tensor(q), tc)
    assert ti.dtype == torch.int32 and ts.dtype == torch.float32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOPK_TOL,
                               atol=TOPK_TOL)
    assert fc.topk_vs_bruteforce(tp["item_emb"], torch.tensor(q), ti,
                                 tc) == 5
    seq = np.random.default_rng(4).integers(1, n_items + 1, (3, jc.seq_len))
    seq[1, 5:] = 0
    seq[2, :] = 0
    seq = seq.astype(np.int32)
    js, ji = jb4r.serve_scores(jp, {"seq": jnp.asarray(seq)}, jc)
    with torch.no_grad():
        ts, ti = model.serve({"seq": torch.tensor(seq)})
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=TOPK_TOL,
                               atol=TOPK_TOL)


def _example():
    spec = importlib.util.spec_from_file_location("recsys_patterns", EXAMPLE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_integration_path_matches_example():
    """The example's chain in JAX (its own ``session_to_graphseq``, the
    JAX miner, ``PatternServer``, ``embedding_bag`` and chunked top-k at
    its demo config) against ``torch_family_checks.recsys_integration``
    on the CPU under all three serving layouts: equal graph sequences,
    a bit-equal feature matrix and equal top-k ids."""
    import random

    from repro.core.compile import compile_sequence
    from repro.mining.driver import AcceleratedMiner
    from repro.models.embedding import embedding_bag
    from repro.serving import PatternServer, compile_bank

    ex = _example()
    sessions, db_t = fc.example_sessions()
    rng = random.Random(0)
    # the example's session draw, then its graph sequences
    want_sessions = []
    for _ in range(fc.N_SESSIONS):
        base = rng.randrange(4) * 10
        want_sessions.append([base + rng.randrange(4) for _ in range(5)])
    assert sessions == want_sessions
    seqs = [ex.session_to_graphseq(s, rng) for s in want_sessions]
    db = [compile_sequence(s) for s in seqs]
    assert [pattern_key(s) for s in db] == [pattern_key(s) for s in db_t]

    res = AcceleratedMiner(db).mine_rs(min_support=fc.SIGMA,
                                       max_len=fc.MAX_LEN)
    bank = compile_bank(res, top=fc.TOP)
    feats = np.stack([r.contained for r in
                      PatternServer(bank, topk=8).query(db)]).astype(
        np.float32)
    jc = jb4r.Bert4RecConfig(name="demo", **fc.DEMO)
    jp = jb4r.init_params(jax.random.PRNGKey(0), jc)
    # the example's own padding of the sessions to seq_len
    seqs = jnp.asarray(
        [[min(i + 1, 64) for i in s[: jc.seq_len]]
         + [0] * (jc.seq_len - len(s[: jc.seq_len])) for s in sessions])
    hidden = jb4r.encode(jp, seqs, jc)
    pat_table = jax.random.normal(jax.random.PRNGKey(1),
                                  (bank.n_patterns, jc.d_model)) * 0.1
    nz = np.nonzero(feats)
    pat_emb = embedding_bag(pat_table, jnp.asarray(nz[1], jnp.int32),
                            jnp.asarray(nz[0], jnp.int32), len(db),
                            mode="mean")
    js, ji = jb4r.chunked_topk_scores(jp, hidden[:, -1] + pat_emb, jc)

    tc = tb4r.Bert4RecConfig(name="demo", **fc.DEMO)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp))
    got = fc.recsys_integration(
        tp, torch.tensor(np.asarray(pat_table)), tc, "cpu",
        layouts=("flat", "trie", "trie_fused"))
    assert {pattern_key(p): v for p, v in got["res"].patterns.items()} == \
        {pattern_key(p): v for p, v in res.patterns.items()}
    np.testing.assert_array_equal(got["feats"], feats)
    np.testing.assert_array_equal(got["ids"].numpy(), np.asarray(ji))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(js),
                               rtol=TOPK_TOL, atol=TOPK_TOL)


SHARDED_CFG = dict(name="b", n_items=298, seq_len=16, v_chunk=64, topk=7)
JAX_SHARDED = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import json
import numpy as np
import jax, jax.numpy as jnp
from repro.models import bert4rec as jb4r

inputs, cfg_kw, out_path = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
a = np.load(inputs)
params = {}
for key in a.files:
    if key == "seq":
        continue
    *outer, leaf = key.split("/")
    d = params
    for k in outer:
        d = d.setdefault(k, {})
    d[leaf] = jnp.asarray(a[key])
cfg = jb4r.Bert4RecConfig(**cfg_kw)
mesh = jax.make_mesh((4, 2), ("data", "model"))
serve = jb4r.make_sharded_serve(cfg, mesh, ("data",))
s, i = serve(params, {"seq": jnp.asarray(a["seq"])})
np.savez(out_path, scores=np.asarray(s), ids=np.asarray(i))
print("JAX-B4R-SHARDED-OK")
"""


def test_sharded_serve_matches_jax(tmp_path):
    """``make_sharded_serve`` on 8 gloo ranks, mesh (4, 2): each rank's
    block of rows equals the JAX serve's on 8 devices (ids equal, scores
    within 1e-5; the catalog's 150-row shards end in a padded chunk);
    the arch's serve step over the mesh takes the sharded serve at batch
    512 and ``serve_scores`` at batch 1."""
    import json

    jc, tc = _cfgs(**SHARDED_CFG)
    jp = jb4r.init_params(jax.random.PRNGKey(5), jc)
    rng = np.random.default_rng(6)
    seq = rng.integers(1, jc.n_items + 1, (8, jc.seq_len))
    seq[1, 4:] = 0
    seq[6, 1:] = 0
    arrays = {path_str(p): v for p, v in
              tree_leaves_with_path(jax.tree.map(np.asarray, jp))}
    arrays["seq"] = seq.astype(np.int32)
    inputs = str(tmp_path / "inputs.npz")
    np.savez(inputs, **arrays)
    out = str(tmp_path / "jax.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SHARDED, inputs, json.dumps(
            SHARDED_CFG), out], capture_output=True, text=True,
        timeout=600, cwd=os.path.join(os.path.dirname(__file__), ".."),
        env=env)
    assert "JAX-B4R-SHARDED-OK" in proc.stdout, proc.stdout + proc.stderr
    want = np.load(out)
    ranks = run_world(recsys_serve_job, 8, str(tmp_path), inputs,
                      SHARDED_CFG, 2, "cpu")
    assert sorted((int(r["row"]), int(r["model"])) for r in ranks) == \
        [(d, m) for d in range(4) for m in range(2)]
    for r in ranks:
        rows = slice(2 * int(r["row"]), 2 * int(r["row"]) + 2)
        np.testing.assert_array_equal(r["ids"], want["ids"][rows])
        np.testing.assert_allclose(r["scores"], want["scores"][rows],
                                   rtol=TOPK_TOL, atol=TOPK_TOL)
        assert r["many_global"] and not r["one_global"]
        np.testing.assert_array_equal(r["one_ids"], r["ref_ids"])
        np.testing.assert_array_equal(r["one_scores"], r["ref_scores"])
    # the unsharded serve agrees where no id falls in a padded chunk
    ts, ti = tb4r.serve_scores(params_from_numpy(
        jax.tree.map(np.asarray, jp), tc).tree(),
        {"seq": torch.tensor(arrays["seq"])}, tc)
    np.testing.assert_array_equal(ti.detach().numpy(), want["ids"])
