"""The multi-rank mining step, port vs the JAX package, on the CPU: the
fixed-size unique against ``jnp.unique(size=k)``, the single-device
candidate table and merge, and the whole step on a gloo world of 8
ranks against ``repro.mining.distributed.make_mining_step`` on 8
virtual CPU devices (one subprocess: the device count is locked at
JAX's first init).  Both sides scan the same arrays, written by this
file: the root scan of a small DB and one extension scan of a mined
one-TR pattern, over a (4, 2) ("data", "model") mesh and a (2, 2, 2)
("pod", "data", "model") mesh, both ``prededup`` modes, at a k that
holds every signature and at one that cuts them."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_db
from repro.mining import driver as j_driver
from repro.mining.encoding import encode_db, encode_embeddings, \
    encode_pattern_trs, PAD_PHI, PAD_PSI
from repro.mining.engine import MODE_ROOT, aggregate_host, \
    match_signatures as j_match_signatures
from repro.mining.engine import candidate_table_device as j_candidate_table
from repro.mining.engine import merge_tables as j_merge_tables
from repro.mining import distributed as j_dist

from repro_torch.mining import distributed as t_dist

from repro_torch.mining.engine import _segment_sum, _unique_fixed, \
    candidate_table_device, merge_tables
from torch_dist_worker import mining_job, run_world

ROOT = os.path.join(os.path.dirname(__file__), "..")
N_SEQ, N_DB = 16, 4          # sequences; DB shards of both meshes
NI, NV, P = 16, 12, 64       # the miner's widths
K_ALL, K_CUT = 1024, 4
MESHES = (("host", ("data",)), ("2x2x2", ("pod", "data")))
SCANS = ("root", "ext")
CASES = [(mesh, db_axes, prededup, k, scan)
         for mesh, db_axes in MESHES for prededup in (False, True)
         for k in (K_ALL, K_CUT) for scan in SCANS]

JAX_SCRIPT = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np
import jax, jax.numpy as jnp
from repro.compat import set_mesh_compat
from repro.mining.distributed import make_mining_step

inputs, cases_path, out_path = sys.argv[1:]
a = np.load(inputs)
meshes = {"host": jax.make_mesh((4, 2), ("data", "model")),
          "2x2x2": jax.make_mesh((2, 2, 2), ("pod", "data", "model"))}
steps, out = {}, {}
for i, (mesh, db_axes, prededup, k, scan) in enumerate(
        json.load(open(cases_path))):
    key = (mesh, tuple(db_axes), prededup, k)
    if key not in steps:
        steps[key] = make_mining_step(meshes[mesh], k=k,
                                      db_axes=tuple(db_axes),
                                      tok_axis="model", prededup=prededup)
    with set_mesh_compat(meshes[mesh]):
        res = steps[key](*[jnp.asarray(a[n]) for n in (
            "tokens", scan + "_gid", scan + "_phi", scan + "_psi",
            scan + "_valid", scan + "_existing")],
            *[jnp.int32(a[scan + n]) for n in ("_nv", "_n_pat", "_mode")])
    for name, x in zip(("uniq", "counts", "n_distinct"), res):
        out[f"{i}_{name}"] = np.asarray(x)
np.savez(out_path, **out)
print("JAX-MINING-OK", len(steps))
"""


def _by_shard(gid, phi, psi, g_loc):
    """Rows regrouped by DB shard (``gid // g_loc``) into ``N_DB`` equal
    blocks, padded with ``valid = 0`` rows; gids made shard-local."""
    shard = gid // g_loc
    per = max(4, int(np.bincount(shard, minlength=N_DB).max()))
    E = N_DB * per
    out_gid = np.zeros(E, np.int32)
    out_phi = np.full((E, phi.shape[1]), PAD_PHI, np.int32)
    out_psi = np.full((E, psi.shape[1]), PAD_PSI, np.int32)
    valid = np.zeros(E, np.int32)
    for s in range(N_DB):
        rows = np.nonzero(shard == s)[0]
        at = slice(s * per, s * per + len(rows))
        out_gid[at] = gid[rows] % g_loc
        out_phi[at], out_psi[at], valid[at] = phi[rows], psi[rows], 1
    return out_gid, out_phi, out_psi, valid, per


def _ext_scan(db):
    """The rows of one extension scan of the JAX miner: the one-TR
    pattern (mode 1 or 2) with the most valid rows."""
    got = []
    orig = j_driver.match_signatures_batch

    def record(*args):
        got.append([np.asarray(x) for x in args])
        return orig(*args)

    j_driver.match_signatures_batch = record
    try:
        j_driver.AcceleratedMiner(db).mine_rs(2, max_len=2)
    finally:
        j_driver.match_signatures_batch = orig
    best = None
    for tok, gid, phi, psi, valid, pid, ex, nv, npat, mode in got:
        for p in np.unique(pid[valid > 0]):
            rows = np.nonzero((pid == p) & (valid > 0))[0]
            if npat[p] == 1 and mode[p] in (1, 2) and \
                    (best is None or len(rows) > len(best[0])):
                best = (gid[rows], phi[rows], psi[rows], ex[p], nv[p],
                        npat[p], mode[p])
    return best


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    """The inputs of both scans, in an ``.npz`` both sides read, and the
    single-device JAX signatures of each (global gids)."""
    work = tmp_path_factory.mktemp("dist_mining")
    db = random_db(3, n_seq=N_SEQ, n_steps=5, n_v=5)
    tokens = encode_db(db, pad_to=64).tokens
    g_loc = N_SEQ // N_DB
    gid, phi, psi = encode_embeddings(
        [(g, (), ()) for g in range(N_SEQ)], NI, NV)
    root = (gid, phi, psi, encode_pattern_trs((), P), 0, 0, MODE_ROOT)
    arrays, sigs = {"tokens": tokens}, {}
    for scan, (gid, phi, psi, ex, nv, npat, mode) in \
            (("root", root), ("ext", _ext_scan(db))):
        lgid, lphi, lpsi, valid, per = _by_shard(gid, phi, psi, g_loc)
        arrays.update({f"{scan}_gid": lgid, f"{scan}_phi": lphi,
                       f"{scan}_psi": lpsi, f"{scan}_valid": valid,
                       f"{scan}_existing": ex,
                       f"{scan}_nv": np.int32(nv),
                       f"{scan}_n_pat": np.int32(npat),
                       f"{scan}_mode": np.int32(mode)})
        ggid = (lgid + (np.arange(len(lgid)) // per) * g_loc).astype(
            np.int32)
        s = j_match_signatures(*[jnp.asarray(x) for x in (
            tokens, ggid, lphi, lpsi, valid, ex)],
            jnp.int32(nv), jnp.int32(npat), jnp.int32(mode))
        sigs[scan] = (np.array(s), ggid)
    path = str(work / "inputs.npz")
    np.savez(path, **arrays)
    return {"work": work, "path": path, "sigs": sigs}


@pytest.fixture(scope="module")
def steps(scans):
    """Every case's (uniq, counts, n_distinct): the JAX step's and each
    port rank's."""
    work = scans["work"]
    cases_path = str(work / "cases.json")
    with open(cases_path, "w") as f:
        json.dump(CASES, f)
    out_path = str(work / "jax_out.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, scans["path"], cases_path,
         out_path], capture_output=True, text=True, timeout=600,
        cwd=ROOT, env=env)
    assert "JAX-MINING-OK" in proc.stdout, proc.stdout + proc.stderr
    with np.load(out_path) as f:
        jax_out = {k: f[k] for k in f.files}
    ranks = run_world(mining_job, 8, str(work), scans["path"], CASES, "cpu")
    return jax_out, ranks


@pytest.mark.parametrize("x,k", [
    ([5, -1, 3, 5, 9, 7, 3, -1], 3),   # distinct > k, -1 present
    ([5, -1, 3, 5, 9, 7, 3, -1], 5),   # distinct == k
    ([5, -1, 3, 5, 9, 7, 3, -1], 8),   # distinct < k
    ([5, 3, 5, 9], 2),                 # > k, no -1
    ([5, 3, 5, 9], 3),                 # == k
    ([5, 3, 5, 9], 6),                 # < k
    ([], 4),
])
def test_unique_fixed_matches_jnp_unique(x, k):
    """Values, dtype and padding of the cut, and the inverse wherever it
    is < k; the values cut off add nothing to a segment sum."""
    want_u, want_inv = jnp.unique(jnp.asarray(x, jnp.int32), size=k,
                                  fill_value=-1, return_inverse=True)
    uniq, inv = _unique_fixed(torch.tensor(x, dtype=torch.int32), k)
    np.testing.assert_array_equal(uniq.numpy(), np.asarray(want_u))
    assert uniq.dtype == torch.int32
    want_inv = np.asarray(want_inv).reshape(-1)
    inside = want_inv < k
    np.testing.assert_array_equal(inv.numpy()[inside], want_inv[inside])
    assert (inv.numpy()[~inside] >= k).all()
    vals = np.arange(1, len(x) + 1, dtype=np.int32)
    want_sum = np.zeros(k, np.int64)
    np.add.at(want_sum, want_inv[inside], vals[inside])
    got = _segment_sum(torch.from_numpy(vals), inv, k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want_sum)


@pytest.mark.parametrize("kp", (5, 40, 400))
def test_pair_tables_match_jax(kp):
    """The step's table functions on pairs with duplicates inside and
    across two token shards, -1 signatures and gids of both signs: the
    ``jnp.lexsort`` order, ``_dedup_pairs``' dump slot and cut, and the
    tables built on them, equal to the JAX package's."""
    rng = np.random.default_rng(kp)
    sigs = rng.integers(-1, 12, (2, 30, 7)).astype(np.int32)
    gids = rng.integers(-3, 9, (2, 30)).astype(np.int32)
    flat = []
    for half in range(2):  # one token shard's pair table each
        fs = sigs[half].reshape(-1)
        fg = np.repeat(gids[half], 7)
        got = t_dist._dedup_pairs(torch.from_numpy(fs), torch.from_numpy(fg),
                                  kp)
        want = j_dist._dedup_pairs(jnp.asarray(fs), jnp.asarray(fg), kp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        flat.append(got[:2])
    fs, fg = (torch.cat([f[i] for f in flat]) for i in (0, 1))
    cases = [(t_dist._flat_candidate_table(fs, fg, kp),
              j_dist._flat_candidate_table(jnp.asarray(fs.numpy()),
                                           jnp.asarray(fg.numpy()), kp)),
             (t_dist._local_candidate_table(torch.from_numpy(sigs[0]),
                                            torch.from_numpy(gids[0]), kp),
              j_dist._local_candidate_table(jnp.asarray(sigs[0]),
                                            jnp.asarray(gids[0]), kp))]
    tables = [c[0] for c in cases]
    cases.append((t_dist._merge_tables(
        torch.stack([t[0] for t in tables]),
        torch.stack([t[1] for t in tables]), kp),
        j_dist._merge_tables(jnp.asarray(np.stack([t[0].numpy()
                                                   for t in tables])),
                             jnp.asarray(np.stack([t[1].numpy()
                                                   for t in tables])), kp)))
    for got, want in cases:
        for g, w in zip(got, want):
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", (K_ALL, K_CUT))
@pytest.mark.parametrize("scan", SCANS)
def test_candidate_table_and_merge_match_jax(scans, scan, k):
    """``candidate_table_device`` on the whole scan and ``merge_tables``
    of its four DB shards' tables, equal to the JAX package's."""
    sigs, gid = scans["sigs"][scan]
    want = j_candidate_table(jnp.asarray(sigs), jnp.asarray(gid), k)
    got = candidate_table_device(torch.from_numpy(sigs),
                                 torch.from_numpy(gid), k)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and np.asarray(w).dtype == np.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    parts = np.split(np.arange(len(gid)), N_DB)
    j_parts = [j_candidate_table(jnp.asarray(sigs[r]), jnp.asarray(gid[r]),
                                 k) for r in parts]
    t_parts = [candidate_table_device(torch.from_numpy(sigs[r]),
                                      torch.from_numpy(gid[r]), k)
               for r in parts]
    want = j_merge_tables([u for u, _ in j_parts], [c for _, c in j_parts],
                          k)
    got = merge_tables([u for u, _ in t_parts], [c for _, c in t_parts], k)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=["-".join(map(str, (c[0], "pre" if c[2] else
                                                 "full", c[3], c[4])))
                              for c in CASES])
def test_mining_step_matches_jax(scans, steps, case):
    """The port's step on every rank equals the JAX step in value and
    dtype, and, where k holds every signature, ``aggregate_host``'s
    distinct-gid counts."""
    jax_out, ranks = steps
    mesh, db_axes, prededup, k, scan = CASES[case]
    for name in ("uniq", "counts", "n_distinct"):
        want = jax_out[f"{case}_{name}"]
        for r, out in enumerate(ranks):
            got = out[f"{case}_{name}"]
            assert got.dtype == want.dtype == np.int32, (name, r)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} r{r}")
    n_distinct = int(jax_out[f"{case}_n_distinct"])
    sigs, gid = scans["sigs"][scan]
    host = {s: len(g) for s, (g, _) in aggregate_host(sigs, gid).items()}
    # n_distinct is the most distinct signatures of any one DB shard
    shard_max = max(len(np.unique(part[part >= 0]))
                    for part in np.split(sigs, N_DB))
    uniq, counts = jax_out[f"{case}_uniq"], jax_out[f"{case}_counts"]
    got = {int(s): int(c) for s, c in zip(uniq, counts) if s >= 0}
    if k == K_ALL:
        assert got == host and n_distinct == shard_max
    else:  # a k below the distinct count cuts the tables
        assert len(host) > k and set(got) <= set(host)
        assert n_distinct <= shard_max
        if not prededup:
            assert n_distinct == shard_max


def test_mining_step_runs_the_plain_scan_on_cpu(steps):
    """A CPU mesh scans with match_count's plain version: no rank
    launched the kernel."""
    _, ranks = steps
    assert [int(out["launches"]) for out in ranks] == [0] * 8


def test_meshes_the_world_cannot_hold_are_refused(steps):
    """On a world of 8: ``make_host_mesh(model=3)`` and both production
    meshes (256 and 512 ranks) raise on every rank."""
    _, ranks = steps
    for out in ranks:
        assert out["refused"].tolist() == [True, True, True]


def test_db_axes_group_made_once_a_mesh(steps):
    """The group over ("pod","data") of the (2,2,2) mesh is made at the
    first step built on it and kept: a later call returns that group,
    of the 4 ranks that share a model coordinate, and makes none."""
    _, ranks = steps
    assert sum(1 for c in CASES if c[0] == "2x2x2") > 1
    for out in ranks:
        assert out["db_group_kept"].tolist() == [True, True]
