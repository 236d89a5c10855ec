"""The multi-rank steps on the card: a gloo world of 2 ranks that share
``cuda:0`` runs the mining step (both ``prededup`` modes) and the flat
serving step on CUDA tensors, equal to the single-rank results of the
kernels' plain versions, with one match_count launch per mining step
and one contain_step launch per predicate call on each rank.  Imports torch and the port only, so it
runs on a machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_distributed_cuda.py
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core.compile import compile_sequence
from repro_torch.data.synthetic import random_graph_sequence
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.mining.encoding import encode_db, encode_embeddings, \
    encode_pattern_trs
from repro_torch.mining.engine import MODE_ROOT, candidate_table_device, \
    match_signatures_ref
from repro_torch.serving.bank import compile_bank
from repro_torch.serving.batch import batch_contains, max_key_bucket
from torch_dist_worker import mining_job, run_world, serving_job

# gloo carries the CUDA tensors of ranks that share one card; NCCL takes
# one rank a card
BACKEND = "cpu:gloo,cuda:gloo"


def _need_card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 device")


def _db(seed, n_seq):
    rng = random.Random(seed)
    return [compile_sequence(random_graph_sequence(
        rng, n_steps=5, n_v=5, n_vl=2, n_el=2)) for _ in range(n_seq)]


@pytest.mark.cuda
def test_steps_on_two_gloo_ranks_sharing_the_card(tmp_path):
    _need_card()
    db = _db(5, 8)
    tokens = encode_db(db, pad_to=64).tokens
    gid, phi, psi = encode_embeddings([(g, (), ()) for g in range(8)],
                                      16, 12)
    valid = np.ones(8, np.int32)
    existing = encode_pattern_trs((), 64)
    path = str(tmp_path / "mining.npz")
    np.savez(path, tokens=tokens, root_gid=gid, root_phi=phi, root_psi=psi,
             root_valid=valid, root_existing=existing, root_nv=0,
             root_n_pat=0, root_mode=MODE_ROOT)
    cases = [("host", ("data",), prededup, 1024, "root")
             for prededup in (False, True)]
    ranks = run_world(mining_job, 2, str(tmp_path), path, cases, "cuda",
                      backend=BACKEND)
    cuda = [torch.from_numpy(x).cuda() for x in
            (tokens, gid, phi, psi, valid, existing)]
    # the references are the plain versions, on the card for the scan
    # and on the CPU for the join
    sigs = match_signatures_ref(*cuda, 0, 0, MODE_ROOT)
    uniq, counts = candidate_table_device(sigs, cuda[1], 1024)
    for out in ranks:
        assert int(out["launches"]) == len(cases)
        for i in range(len(cases)):
            np.testing.assert_array_equal(out[f"{i}_uniq"],
                                          uniq.cpu().numpy())
            np.testing.assert_array_equal(out[f"{i}_counts"],
                                          counts.cpu().numpy())

    res = AcceleratedMiner(db, device="cpu").mine_rs(2, max_len=3)
    n_pat = len([p for p in res.patterns if p])
    bank = compile_bank(res, pad_patterns_to=-(-n_pat // 2) * 2)
    q = encode_db(_db(6, 8)).tokens
    tmax = max_key_bucket(q, bank.n_label_keys)
    path = str(tmp_path / "serving.npz")
    np.savez(path, tokens=q, steps=bank.steps,
             pattern_valid=bank.pattern_valid, nv=bank.nv,
             n_label_keys=bank.n_label_keys, tmax=tmax)
    ranks = run_world(serving_job, 2, str(tmp_path), path, [("flat", 4)],
                      "cuda", backend=BACKEND)
    want = batch_contains(
        torch.from_numpy(q), torch.from_numpy(bank.steps),
        torch.from_numpy(bank.pattern_valid), nv=bank.nv,
        n_label_keys=bank.n_label_keys, emax=4, tmax=tmax)
    for out in ranks:
        assert int(out["launches"]) == int(out["predicate_calls"]) > 0
        np.testing.assert_array_equal(out["0_contained"],
                                      want[0].numpy())
        np.testing.assert_array_equal(out["0_overflow"],
                                      want[1].numpy())
