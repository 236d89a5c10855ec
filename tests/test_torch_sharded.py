"""The sharded serving steps, port vs the JAX package, on the CPU: the
flat step (shard by pattern row) and the trie step (shard by depth-1
subtree) on a gloo world of 8 ranks, mesh (4, 2) ("data", "model"),
against ``repro.serving.sharded`` on 8 virtual CPU devices (one
subprocess).  The bank is mined and compiled by the JAX package and
carried across with ``bank_from_reference``, so both sides join the
same programs; each side encodes the queries, builds its trie shards
and stacks them itself."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import random_db
from repro.core.containment import contains
from repro.mining.driver import AcceleratedMiner as JaxMiner
from repro.mining.encoding import encode_db as j_encode_db
from repro.serving.bank import compile_bank as j_compile_bank
from repro.serving.batch import max_key_bucket as j_max_key_bucket
from repro.serving.sharded import stack_trie_shards as j_stack_trie_shards
from repro.serving.trie import build_trie as j_build_trie

from repro_torch.core.graphseq import db_from_reference, pattern_key
from repro_torch.mining.encoding import encode_db
from repro_torch.serving import batch_contains, max_key_bucket, \
    stack_trie_shards, trie_contains
from repro_torch.serving.bank import bank_from_reference
from repro_torch.serving.trie import build_trie
from torch_dist_worker import run_world, serving_job

ROOT = os.path.join(os.path.dirname(__file__), "..")
CASES = [("flat", 16), ("flat", 1), ("trie", 16)]
STACK_KEYS = ("lvl_steps", "lvl_parent_pos", "term_level", "term_pos",
              "pattern_valid")

JAX_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, "src")
import numpy as np
import jax, jax.numpy as jnp
from repro.serving.sharded import make_serving_step, make_trie_serving_step

inputs, out_path = sys.argv[1:]
a = np.load(inputs)
mesh = jax.make_mesh((4, 2), ("data", "model"))
kw = dict(nv=int(a["nv"]), n_label_keys=int(a["n_label_keys"]),
          tmax=int(a["tmax"]))
out = {}
for i, (layout, emax) in enumerate(
        [("flat", 16), ("flat", 1), ("trie", 16)]):
    if layout == "flat":
        step = make_serving_step(mesh, emax=emax, **kw)
        names = ("tokens", "steps", "pattern_valid")
    else:
        step = make_trie_serving_step(mesh, emax=emax, **kw)
        names = ("tokens", "lvl_steps", "lvl_parent_pos", "term_level",
                 "term_pos", "trie_valid")
    c, o = step(*[jnp.asarray(a[n]) for n in names])
    out[f"{i}_contained"], out[f"{i}_overflow"] = np.asarray(c), \
        np.asarray(o)
np.savez(out_path, **out)
print("JAX-SHARDED-OK")
"""


def _inputs(tokens, bank, flat_bank, stack, tmax):
    return {"tokens": tokens, "steps": flat_bank.steps,
            "pattern_valid": flat_bank.pattern_valid,
            "lvl_steps": stack["lvl_steps"],
            "lvl_parent_pos": stack["lvl_parent_pos"],
            "term_level": stack["term_level"],
            "term_pos": stack["term_pos"],
            "trie_valid": stack["pattern_valid"],
            "nv": np.int32(bank.nv),
            "n_label_keys": np.int32(bank.n_label_keys),
            "tmax": np.int32(tmax)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' banks, stacks and inputs, the JAX steps' outputs
    and every port rank's."""
    work = tmp_path_factory.mktemp("sharded")
    db = random_db(3, n_seq=8, n_steps=4, n_v=4)
    res = JaxMiner(db).mine_rs(2, max_len=4)
    n_pat = len([p for p in res.patterns if p])
    j_flat = j_compile_bank(res, pad_patterns_to=-(-n_pat // 2) * 2)
    j_bank = j_compile_bank(res)
    j_stack = j_stack_trie_shards(j_build_trie(j_bank).shard(2))
    j_tok = j_encode_db(db).tokens
    j_in = _inputs(j_tok, j_bank, j_flat, j_stack,
                   j_max_key_bucket(j_tok, j_bank.n_label_keys))

    t_flat, t_bank = bank_from_reference(j_flat), bank_from_reference(j_bank)
    t_stack = stack_trie_shards(build_trie(t_bank).shard(2))
    t_tok = encode_db(db_from_reference(db)).tokens
    t_in = _inputs(t_tok, t_bank, t_flat, t_stack,
                   max_key_bucket(t_tok, t_bank.n_label_keys))

    paths = {}
    for side, arrays in (("jax", j_in), ("port", t_in)):
        paths[side] = str(work / f"{side}_inputs.npz")
        np.savez(paths[side], **arrays)
    out_path = str(work / "jax_out.npz")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SCRIPT, paths["jax"], out_path],
        capture_output=True, text=True, timeout=600, cwd=ROOT, env=env)
    assert "JAX-SHARDED-OK" in proc.stdout, proc.stdout + proc.stderr
    with np.load(out_path) as f:
        jax_out = {k: f[k] for k in f.files}
    ranks = run_world(serving_job, 8, str(work), paths["port"], CASES, "cpu")
    return {"db": db, "j_flat": j_flat, "j_stack": j_stack,
            "t_stack": t_stack,
            "j_in": j_in, "t_in": t_in, "jax_out": jax_out,
            "ranks": ranks}


def test_stack_trie_shards_matches_jax(served):
    """The port's stack of its own trie shards equals the JAX package's,
    key by key, patterns included."""
    j_stack, t_stack = served["j_stack"], served["t_stack"]
    assert sorted(t_stack) == sorted(j_stack)
    for key in STACK_KEYS:
        assert t_stack[key].dtype == j_stack[key].dtype, key
        np.testing.assert_array_equal(t_stack[key], j_stack[key],
                                      err_msg=key)
    for key in ("rows_per_shard", "n_shards"):
        assert t_stack[key] == j_stack[key], key
    assert [[pattern_key(p) for p in sh] for sh in t_stack["patterns"]] \
        == [[pattern_key(p) for p in sh] for sh in j_stack["patterns"]]
    for key in served["j_in"]:
        np.testing.assert_array_equal(served["t_in"][key],
                                      served["j_in"][key], err_msg=key)


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{lay}-emax{e}" for lay, e in CASES])
def test_sharded_step_matches_jax(served, case):
    """(contained, overflow) on every rank equal the JAX step's bit for
    bit, and the port's single-rank join of each block."""
    layout, emax = CASES[case]
    jax_out, t_in = served["jax_out"], served["t_in"]
    for name in ("contained", "overflow"):
        want = jax_out[f"{case}_{name}"]
        assert want.dtype == np.bool_
        for r, out in enumerate(served["ranks"]):
            np.testing.assert_array_equal(out[f"{case}_{name}"], want,
                                          err_msg=f"{name} rank {r}")
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in t_in.items()}
    kw = dict(nv=int(t_in["nv"]), n_label_keys=int(t_in["n_label_keys"]),
              emax=emax, tmax=int(t_in["tmax"]))
    if layout == "flat":
        single = batch_contains(t["tokens"], t["steps"],
                                t["pattern_valid"], **kw)
    else:  # each shard's sub-trie joined whole, columns side by side
        S, Pl = 2, served["t_stack"]["rows_per_shard"]
        Mh = t["lvl_steps"].shape[1] // S
        parts = [trie_contains(
            t["tokens"], t["lvl_steps"][:, s * Mh:(s + 1) * Mh].contiguous(),
            t["lvl_parent_pos"][:, s * Mh:(s + 1) * Mh].contiguous(),
            t["term_level"][s * Pl:(s + 1) * Pl],
            t["term_pos"][s * Pl:(s + 1) * Pl],
            t["trie_valid"][s * Pl:(s + 1) * Pl], **kw) for s in range(S)]
        single = tuple(torch.cat([p[i] for p in parts], 1) for i in (0, 1))
    for got, name in zip(single, ("contained", "overflow")):
        np.testing.assert_array_equal(got.numpy(), jax_out[f"{case}_{name}"],
                                      err_msg=name)


def test_sharded_steps_are_exact_without_overflow(served):
    """At emax 16 no cell overflows and both steps equal the host
    oracle; at emax 1 some cell does (the overflow bits are compared)."""
    db, jax_out = served["db"], served["jax_out"]
    pats = {"flat": served["j_flat"].patterns,
            "trie": [p for sh in served["j_stack"]["patterns"] for p in sh]}
    cols = {"flat": np.nonzero(served["j_in"]["pattern_valid"])[0],
            "trie": np.nonzero(served["j_stack"]["pattern_valid"])[0]}
    for case, (layout, emax) in enumerate(CASES):
        c = jax_out[f"{case}_contained"]
        o = jax_out[f"{case}_overflow"]
        if emax == 1:
            assert o.any()
            continue
        assert not o.any()
        want = np.array([[contains(p, s) for p in pats[layout]]
                         for s in db])
        np.testing.assert_array_equal(c[:, cols[layout]], want)


def test_sharded_steps_join_with_the_plain_predicate_on_cpu(served):
    """Each rank joined its blocks with the plain predicate (CPU mesh):
    predicate calls counted, no kernel launched."""
    for out in served["ranks"]:
        assert int(out["launches"]) == 0
        assert int(out["predicate_calls"]) > 0
