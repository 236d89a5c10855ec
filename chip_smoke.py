#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero before the last
line) on any failure:

1. card and build: prints the card's name and power limit, builds every
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together) and prints the build times;
2. kernels vs their plain PyTorch versions, on the card, at the main
   path's shapes: bit-equality, then timings (CUDA events) of the kernel
   and the plain version beside the kernel's bound;
3. the main path: ``AcceleratedMiner(device="cuda").mine_rs`` on the
   paper's Table 3 default DB (1000 sequences, seed 0, sigma 100,
   max_len 6), held to the port's host oracle
   ``repro_torch.core.reverse_search.mine_gtrace_rs``; the launch counts
   are zeroed just before and read just after, and every kernel of the
   path must have launched, once per device call; a second, profiled run
   reports the device time by kernel;
4. the launcher's ``--algo both`` self-check on ``cuda`` at its default
   size (GTRACE.relevant() == GTRACE-RS);
5. the serving kernels vs their plain versions on the card: contain_step
   on random inputs and on the real inputs of one flat serving batch,
   trie_walk on the Table 3 bank's packed subtrees against the first
   512 queries, with and without forced ``REQ_MASKED`` slots;
   bit-equality, then timings beside each kernel's bound;
6. the serving path: ``PatternServer(device="cuda")`` over the bank of
   phase 3's map (211 rFTSs) answers 1000 Table 3 queries (seed 1)
   under the ``flat``, ``trie`` and ``trie_fused`` layouts; the rows
   are equal across layouts, to the host oracle
   ``repro_torch.core.containment.contains`` on the first 128 queries,
   and again at ``emax=1`` (escalation and host fallback); the launch
   counts are zeroed just before and read just after, and both serving
   kernels must have launched once per predicate call / fused walk; a
   profiled repeat per layout reports the device time by kernel;
7. the serving launcher on ``cuda`` (``--bank-layout trie_fused``, at
   its defaults and at ``--emax 1``);
8. one JSON line describing every ported kernel, then the last line
   ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository around it: without either it
exits non-zero and prints no result.  It imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# bandwidth, and the 32-bit rate outside the tensor cores, used for the
# kernel's int32 compares.
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12

# the main path's scan shapes (AcceleratedMiner defaults on the Table 3
# DB): e_batch 1024, max_itemsets 16, max_vertices 12, MAX_PATTERN_TRS
# 64, wave_patterns 256; T = 33 tokens per sequence
G, T, NI, NV, P, NP = 1000, 33, 16, 12, 64, 256
# csrc sources, one nvcc each, all built together
KERNELS = ("match_count", "containment", "trie_walk")
# the serving phase: Table 3 queries (seed 1) against phase 3's bank
N_QUERIES, MAX_BATCH, EMAX, N_ORACLE = 1000, 512, 4, 128
LAYOUTS = ("flat", "trie", "trie_fused")


def log(msg: str) -> None:
    print(msg, flush=True)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _sleep_cycles_per_ms() -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    stop.record()
    torch.cuda.synchronize()
    return 20_000_000 / start.elapsed_time(stop)


def _time_ms(fn, reps: int, rounds: int = 5):
    """(device ms, host ms) per call of ``fn``.

    Device: median over ``rounds`` of the mean time of ``reps``
    back-to-back calls on CUDA events.  Each round is queued behind a
    device-side sleep longer than the host needs to enqueue it, so the
    events time the device's work and not the host's launch rate.
    Host: wall time per call of one unstalled round, synchronized."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    cycles = _sleep_cycles_per_ms() * (2.0 * host_ms + 1.0)
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles))
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times), host_ms / reps


def _scan_inputs(rng, E, mode):
    """Random per-row scan inputs at the main path's widths: pad tokens,
    padded rows (emb_valid 0), PAD_PHI / PAD_PSI columns, mixed pattern
    ids, existing tables with real rows.  ``mode`` None mixes the four
    search phases across patterns."""
    import numpy as np

    from repro_torch.mining.encoding import PAD_PHI, PAD_PSI, SENT_V

    tokens = np.zeros((G, T, 6), np.int32)
    tokens[..., 0] = rng.integers(0, 6, (G, T))
    tokens[..., 1] = rng.integers(0, 10, (G, T))
    tokens[..., 2] = np.where(tokens[..., 0] >= 3,
                              rng.integers(0, 10, (G, T)), -1)
    tokens[..., 3] = rng.integers(-1, 5, (G, T))
    tokens[..., 4] = np.sort(rng.integers(0, 6, (G, T)), axis=1)
    tokens[..., 5] = 1
    tokens[rng.random((G, T)) < 0.3] = (0, -1, -1, -1, 0, 0)
    gid = rng.integers(0, G, (E,)).astype(np.int32)
    phi = np.sort(rng.integers(0, 6, (E, NI)), axis=1).astype(np.int32)
    phi[np.arange(NI)[None, :] >= rng.integers(0, 5, (E,))[:, None]] = \
        PAD_PHI
    psi = np.full((E, NV), PAD_PSI, np.int32)
    for e in range(E):
        m = int(rng.integers(0, 9))
        psi[e, :m] = rng.permutation(10)[:m]
    valid = (rng.random(E) < 0.85).astype(np.int32)
    pid = rng.integers(0, NP, (E,)).astype(np.int32)
    ex = np.full((NP, P, 5), -9, np.int32)
    k = 6
    ex[:, :k, 0] = rng.integers(0, 3, (NP, k))
    ex[:, :k, 1] = rng.integers(0, 6, (NP, k))
    ex[:, :k, 2] = rng.integers(0, 5, (NP, k))
    ex[:, :k, 3] = np.where(ex[:, :k, 1] <= 2, SENT_V,
                            rng.integers(0, 6, (NP, k)))
    ex[:, :k, 4] = rng.integers(-1, 5, (NP, k))
    nv = rng.integers(0, 8, (NP,)).astype(np.int32)
    npat = rng.integers(0, 5, (NP,)).astype(np.int32)
    modes = (rng.integers(0, 4, (NP,)) if mode is None
             else np.full((NP,), mode)).astype(np.int32)
    return tokens, gid, phi, psi, valid, pid, ex, nv, npat, modes


def _bound_ms(args, sigs_shape):
    """Least time for one scan on these inputs: the bytes it must move
    (the gathered token and existing rows it references, the per-row
    and per-pattern inputs, the output) over HBM bandwidth, against the
    int32 operations these inputs need over the 32-bit peak."""
    import torch

    tokens, gid, phi, psi, valid, pid, ex, nv, npat, modes = args
    n_g = int(torch.unique(gid).numel())
    n_p = int(torch.unique(pid).numel())
    E = gid.shape[0]
    nbytes = 4 * (n_g * T * 6 + n_p * P * 5 + E * (NI + NV + 3)
                  + 3 * n_p + sigs_shape[0] * sigs_shape[1])
    tok = tokens[gid.long()]                        # [E,T,6]
    active = (tok[..., 5] > 0) & (valid[:, None] > 0)
    in_any = (phi[:, None, :] == tok[..., 4:5]).any(-1) & active
    # per active pair: two psi lookups, the phi position and gap count,
    # ~30 scalar ops (gates, slot, packing); the duplicate check (5
    # compares per existing row) only for in-itemset slots
    ops = (int(active.sum()) * (2 * NV + 2 * NI + 30)
           + int(in_any.sum()) * 5 * P)
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations"), nbytes, ops


def phase_build() -> dict:
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        libs = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name in KERNELS:
        _build.load(name)
        log(f"[build] {name}: {os.path.relpath(libs[name], ROOT)} "
            f"nvcc {_build.build_seconds.get(name, 0.0):.2f}s")
    log(f"[build] all kernels in {time.perf_counter() - t0:.2f}s")
    return libs


def phase_match_count() -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.match_count import ops, ref

    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    max_err = 0
    n_cmp = 0
    for E in (1, 37, 1024):
        for mode in (0, 1, 2, 3, None):
            args = [torch.from_numpy(a).to(dev)
                    for a in _scan_inputs(rng, E, mode)]
            got = ops.match_signatures_batch(*args)
            want = ref.match_signatures_batch_ref(*args)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            if not torch.equal(got, want):
                raise AssertionError(
                    f"match_count per-row E={E} mode={mode}: "
                    f"{int((got != want).sum())} signatures differ")
            max_err = max(max_err, err)
            n_cmp += 1
            if mode is not None and E == 1024:
                # scalar form: one shared table, scalar nv/n_pat/mode
                tokens, gid, phi, psi, valid = args[:5]
                existing = args[6][0]
                got = ops.match_signatures_kernel(
                    tokens, gid, phi, psi, valid, existing, 5, 3, mode)
                want = ref.match_signatures_ref(
                    tokens, gid, phi, psi, valid, existing, 5, 3, mode)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"match_count scalar mode={mode} differs")
                n_cmp += 1
                if mode == 0:
                    assert (want >= 0).any() and (want < 0).any()
    log(f"[match_count] bit-equal to the plain version in {n_cmp} "
        f"comparisons (E in 1/37/1024, T={T}, NI={NI}, NV={NV}, P={P}, "
        f"NP={NP}, 4 modes + mixed, per-row + scalar)")

    args = [torch.from_numpy(a).to(dev)
            for a in _scan_inputs(np.random.default_rng(1), 1024, None)]
    ms, host_ms = _time_ms(lambda: ops.match_signatures_batch(*args),
                           reps=200)
    plain_ms, plain_host_ms = _time_ms(
        lambda: ref.match_signatures_batch_ref(*args), reps=10)
    bound_ms, bound_by, nbytes, nops = _bound_ms(args, (1024, T))
    log(f"[match_count] E=1024 T={T}: kernel {ms:.5f} ms device (median), "
        f"{host_ms:.5f} ms per wrapper call on the host; plain "
        f"{plain_ms:.5f} ms device, {plain_host_ms:.5f} ms host; bound "
        f"{bound_ms:.6f} ms by {bound_by} ({nbytes} B, {nops} int ops); "
        f"{ops.launches} launches so far; library_ms null (no single "
        f"PyTorch call computes this)")
    return {
        "name": "match_count", "route": "cuda",
        "source": "src/repro_torch/csrc/match_count.cu",
        "replaces": "src/repro/kernels/match_count/match_count.py:61",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def phase_main_path() -> dict:
    import torch

    from repro_torch.core.reverse_search import mine_gtrace_rs
    from repro_torch.data.synthetic import Table3Params, generate_table3_db
    from repro_torch.kernels.match_count import ops
    from repro_torch.mining.driver import AcceleratedMiner

    params = Table3Params(db_size=1000, v_avg=6, n_interstates=5)
    db = generate_table3_db(params, seed=0)
    sigma, max_len = 100, 6
    t0 = time.perf_counter()
    oracle = mine_gtrace_rs(db, sigma, max_len=max_len)
    log(f"[main] host oracle: {len(oracle.patterns)} rFTSs in "
        f"{time.perf_counter() - t0:.2f}s")

    miner = AcceleratedMiner(db, device="cuda")
    ops.launches = 0
    t0 = time.perf_counter()
    res = miner.mine_rs(sigma, max_len=max_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"match_count": ops.launches}
    if res.patterns != oracle.patterns:
        raise AssertionError(
            f"card mined {len(res.patterns)} rFTSs, host oracle "
            f"{len(oracle.patterns)}; the maps differ")
    calls = miner.n_device_calls
    if not (calls > 0 and launches["match_count"] == calls):
        raise AssertionError(
            f"match_count launched {launches['match_count']} times for "
            f"{calls} device calls")
    log(f"[main] Table 3 (|DB|=1000, v_avg 6, 5 interstates, seed 0) "
        f"sigma={sigma} max_len={max_len} on cuda: {len(res.patterns)} "
        f"rFTSs == host oracle; wall {wall:.3f}s, device_seconds "
        f"{miner.device_seconds:.3f}s, dispatch_seconds "
        f"{miner.dispatch_seconds:.3f}s, {calls} device calls, "
        f"match_count launches {launches['match_count']}")

    # a second run under the profiler (device activity only): device
    # time by kernel and copy, against the unprofiled run's wall
    from torch.profiler import ProfilerActivity, profile

    prof_miner = AcceleratedMiner(db, device="cuda")
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prof_miner.mine_rs(sigma, max_len=max_len)
        torch.cuda.synchronize()
    prof_wall = time.perf_counter() - t0
    _log_device_times("[profile]", prof, prof_wall, wall)
    return launches, res


def _log_device_times(tag, prof, prof_wall, wall, top_n=6):
    """Device time by kernel and copy from a profiler run (device
    activity only), and the device-busy share of the unprofiled
    ``wall``."""
    dev = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if us and ev.key and not ev.key.startswith("aten::") \
                and not ev.key.startswith("cuda"):
            tot, n = dev.get(ev.key, (0.0, 0))
            dev[ev.key] = (tot + us, n + ev.count)
    if dev:
        busy_ms = sum(v[0] for v in dev.values()) / 1e3
        top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:top_n]
        log(f"{tag} device busy {busy_ms:.4f} ms in the profiled run "
            f"(wall {prof_wall:.3f}s) = {100 * busy_ms / 1e3 / wall:.4f}% "
            f"of the unprofiled wall {wall:.3f}s; by name: "
            + "; ".join(f"{k[:48]} {v / 1e3:.4f} ms / {n} = "
                        f"{v / max(n, 1):.2f} us each"
                        for k, (v, n) in top))
    else:
        log(f"{tag} the profiler recorded no device time: not measured")


def _bound(nbytes, nops):
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * nops / PEAK_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _contain_bound(tok, psi, srow):
    """Least time for one contain_step call: each input read once and
    the output written once over HBM bandwidth, against the int32
    operations these inputs need (about 10 per (cell, row, token) pair
    for the type/label/slot gates, and 3 NV + 20 more for the psi
    lookups and orientation tests of the pairs that pass them)."""
    G_, Tm, _ = tok.shape
    _, E_, NV_ = psi.shape
    nbytes = 4 * (tok.numel() + psi.numel() + srow.numel() + G_ * E_ * Tm)
    t = tok[:, None, :, :]
    r = srow[:, :, None, :]
    gate = ((t[..., 5] > 0) & (r[..., 7] > 0) & (t[..., 0] == r[..., 0])
            & (t[..., 3] == r[..., 3])
            & ((r[..., 4] > 0) & (t[..., 4] > r[..., 5])
               | (r[..., 4] <= 0) & (t[..., 4] == r[..., 6])))
    nops = G_ * E_ * Tm * 10 + int(gate.sum()) * (3 * NV_ + 20)
    return (*_bound(nbytes, nops), nbytes, nops)


def _real_cells(cells):
    """The rows of a fused batch's ``cells [npad, 2]`` that name a real
    (sequence, subtree) cell.  The server fills the first n rows from
    ``np.nonzero`` (unique, ascending) and pads with (0, 0), so a (0, 0)
    row past the first is padding."""
    return cells[:1 + int((cells[1:] != 0).any(dim=1).sum())]


def _walk_bound(args, cells, emax, tmax, ni, nv):
    """Least time for one trie_walk call over the batch's real cells:
    each sequence's token table and index rows and each subtree's
    packed tables read once, both outputs of the real cells written
    once, against the int32 operations these inputs need: the K-wide
    prescreen of every slot, and for every slot that passes it the
    window gather, the E*Tm predicate pairs (counted at 3 nv + 30 each),
    the compaction and the E*(ni+nv) state update.  Also returns the
    bytes of the per-cell copies the kernel is handed (padding cells
    included), which a kernel gathering by cell index would not need."""
    import torch

    tok_c, order_c, start_c, count_c, steps, parent, req = args
    N, T, _ = tok_c.shape
    _, S, K = req.shape
    real = _real_cells(cells)
    n = real.shape[0]
    n_seq = int(torch.unique(real[:, 0]).numel())
    n_sub = int(torch.unique(real[:, 1]).numel())
    nbytes = 4 * (n_seq * (7 * T + 2 * K) + n_sub * S * (9 + K) + 2 * n * S)
    copy_bytes = 4 * (sum(a.numel() for a in args) + 2 * N * S)
    live = int((count_c[:n, None, :] >= req[:n]).all(-1).sum())
    nops = (n * S * K + live * (tmax * 8 + emax * tmax * (3 * nv + 30)
                                + 2 * emax * tmax + 6 * emax * (ni + nv)))
    return (*_bound(nbytes, nops), nbytes, nops, n, copy_bytes)


def _abs_err(got, want) -> int:
    """Largest absolute difference of two integer or bool tensors."""
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def serving_setup(res) -> dict:
    """Phase 3's map compiled into the serving bank, its trie, the 1000
    Table 3 queries (seed 1), and the real inputs of the serving
    kernels: one flat batch's contain_step calls and one fused batch's
    trie_walk call, recorded while a server answers the first
    ``MAX_BATCH`` queries."""

    from repro_torch.data.synthetic import Table3Params, generate_table3_db
    from repro_torch.serving import batch
    from repro_torch.serving import server as server_mod
    from repro_torch.serving.bank import compile_bank
    from repro_torch.serving.server import PatternServer
    from repro_torch.serving.trie import build_trie

    t0 = time.perf_counter()
    bank = compile_bank(res)
    trie = build_trie(bank)
    queries = generate_table3_db(
        Table3Params(db_size=N_QUERIES, v_avg=6, n_interstates=5), seed=1)
    log(f"[serving] bank: {bank.n_patterns} rFTSs (max {bank.max_steps} "
        f"TRs, nv {bank.nv}, {bank.n_label_keys} label keys), trie "
        f"{trie.n_nodes} nodes depth {trie.depth}; {len(queries)} "
        f"queries; built in {time.perf_counter() - t0:.2f}s")
    if bank.n_patterns != 211:
        raise AssertionError(f"expected the 211-rFTS bank, got "
                             f"{bank.n_patterns}")
    recorded = {"contain_step": [], "trie_walk": [], "cells": []}
    orig = {"contain_step": batch.contain_step, "trie_walk": batch.trie_walk,
            "fused_trie_walk": server_mod.fused_trie_walk}

    def recorder(name):
        def call(*args, **kw):
            recorded[name].append(
                ([a.clone() for a in args], dict(kw)))
            return orig[name](*args, **kw)
        return call

    def fused(*args, **kw):
        recorded["cells"].append(args[4].clone())
        return orig["fused_trie_walk"](*args, **kw)

    batch.contain_step = recorder("contain_step")
    batch.trie_walk = recorder("trie_walk")
    server_mod.fused_trie_walk = fused
    try:
        first = queries[:MAX_BATCH]
        for layout in ("flat", "trie_fused"):
            srv = PatternServer(bank, device="cuda", max_batch=MAX_BATCH,
                                emax=EMAX, bank_layout=layout, trie=trie)
            srv.query(first)
            if layout == "flat":
                flat_calls = list(recorded["contain_step"])
    finally:
        batch.contain_step = orig["contain_step"]
        batch.trie_walk = orig["trie_walk"]
        server_mod.fused_trie_walk = orig["fused_trie_walk"]
    if not flat_calls or len(recorded["trie_walk"]) != 1 \
            or len(recorded["cells"]) != 1:
        raise AssertionError(
            f"recorded {len(flat_calls)} contain_step calls of the flat "
            f"batch and {len(recorded['trie_walk'])} fused walks")
    return {"bank": bank, "trie": trie, "queries": queries,
            "flat_calls": flat_calls, "walk": recorded["trie_walk"][0],
            "cells": recorded["cells"][0]}


def phase_serving_kernels(setup) -> list:
    import numpy as np
    import torch

    from repro_torch.kernels.containment import ops as cops
    from repro_torch.kernels.containment import ref as cref
    from repro_torch.kernels.trie_walk import ops as wops
    from repro_torch.kernels.trie_walk import ref as wref

    # the random inputs of the port's contain_step tests
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from contain_inputs import contain_inputs

    dev = torch.device("cuda")
    out = []
    # ---- contain_step: random inputs, then the flat batch's real calls
    rng = np.random.default_rng(2)
    n_cmp = max_err = 0
    for G_, E_, Tm in ((1, 1, 1), (65, 4, 9), (4096, 4, 16),
                       (4096, 16, 16)):
        args = [torch.from_numpy(a).to(dev)
                for a in contain_inputs(rng, G_, E_, Tm, 6)]
        got = cops.contain_step(*args)
        want = cref.contain_step_core(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, _abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(
                f"contain_step random G={G_} Ein={E_} Tm={Tm}: "
                f"{int((got != want).sum())} masks differ")
        n_cmp += 1
    flat_calls = setup["flat_calls"]
    for args, _ in flat_calls:
        got = cops.contain_step(*args)
        want = cref.contain_step_core(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, _abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(
                f"contain_step on a flat serving call {tuple(args[1].shape)}"
                f": {int((got != want).sum())} masks differ")
        n_cmp += 1
    big = max(flat_calls, key=lambda c: c[0][0].numel())[0]
    hits = sum(int((cref.contain_step_core(*a) > 0).sum())
               for a, _ in flat_calls)
    log(f"[contain_step] bit-equal to the plain version in {n_cmp} "
        f"comparisons: random (G,Ein,Tm) in (1,1,1)/(65,4,9)/(4096,4,16)/"
        f"(4096,16,16) at NV=6, and all {len(flat_calls)} predicate calls "
        f"of one flat serving batch of {MAX_BATCH} queries ({hits} "
        f"nonzero masks)")
    ms, host_ms = _time_ms(lambda: cops.contain_step(*big), reps=200)
    plain_ms, plain_host_ms = _time_ms(
        lambda: cref.contain_step_core(*big), reps=20)
    bound_ms, bound_by, nbytes, nops = _contain_bound(*big)
    G_, Tm, _ = big[0].shape
    E_, NV_ = big[1].shape[1:]
    log(f"[contain_step] largest flat call G={G_} Ein={E_} Tm={Tm} "
        f"NV={NV_}: kernel {ms:.5f} ms device (median), {host_ms:.5f} ms "
        f"per wrapper call on the host; plain {plain_ms:.5f} ms device, "
        f"{plain_host_ms:.5f} ms host; bound {bound_ms:.6f} ms by "
        f"{bound_by} ({nbytes} B, {nops} int ops); library_ms null (no "
        f"single PyTorch call computes this)")
    out.append({
        "name": "contain_step", "route": "cuda",
        "source": "src/repro_torch/csrc/containment.cu",
        "replaces": "src/repro/kernels/containment/containment.py:52",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    })

    # ---- trie_walk: the fused batch's real call, then forced masks
    args, kw = setup["walk"]
    N, S, K = args[6].shape
    got = wops.trie_walk(*args, **kw)
    want = wref.trie_walk_core(*args, **kw)
    torch.cuda.synchronize()
    max_err = 0
    for g, w, what in zip(got, want, ("acc", "ovf_term")):
        max_err = max(max_err, _abs_err(g, w))
        if not torch.equal(g, w):
            raise AssertionError(f"trie_walk {what}: "
                                 f"{int((g != w).sum())} bits differ")
    n_acc = int(want[0].sum())
    masked = [a.clone() for a in args]
    kill = torch.from_numpy(
        np.random.default_rng(3).random((N, S)) < 0.25).to(dev)
    masked[6][kill] = wref.REQ_MASKED
    got_m = wops.trie_walk(*masked, **kw)
    want_m = wref.trie_walk_core(*masked, **kw)
    torch.cuda.synchronize()
    for g, w, what in zip(got_m, want_m, ("acc", "ovf_term")):
        max_err = max(max_err, _abs_err(g, w))
        if not torch.equal(g, w):
            raise AssertionError(f"trie_walk masked {what}: "
                                 f"{int((g != w).sum())} bits differ")
    if (want_m[0] & kill).any() or (want_m[1] & kill).any():
        raise AssertionError("a REQ_MASKED slot came out set")
    log(f"[trie_walk] bit-equal to the plain version on the fused batch "
        f"of {MAX_BATCH} queries (N={N} cells, S={S} slots, K={K}, "
        f"T={args[0].shape[1]}, {kw}; {n_acc} accepted slots) and with "
        f"{int(kill.sum())} slots forced to REQ_MASKED "
        f"({int(want_m[0].sum())} accepted)")
    ms, host_ms = _time_ms(lambda: wops.trie_walk(*args, **kw), reps=100)
    plain_ms, plain_host_ms = _time_ms(
        lambda: wref.trie_walk_core(*args, **kw), reps=5)
    bound_ms, bound_by, nbytes, nops, n_real, copy_bytes = _walk_bound(
        args, setup["cells"], **kw)
    log(f"[trie_walk] N={N} cells ({n_real} real) S={S}: kernel {ms:.5f} "
        f"ms device (median), {host_ms:.5f} ms per wrapper call on the "
        f"host; plain {plain_ms:.5f} ms device, {plain_host_ms:.5f} ms "
        f"host; bound {bound_ms:.6f} ms by {bound_by} ({nbytes} B of "
        f"distinct sequence and subtree tables, {nops} int ops; the "
        f"per-cell copies the kernel is handed are {copy_bytes} B, "
        f"{1e3 * copy_bytes / PEAK_BYTES_PER_S:.6f} ms); library_ms null "
        f"(no single PyTorch call computes this)")
    out.append({
        "name": "trie_walk", "route": "cuda",
        "source": "src/repro_torch/csrc/trie_walk.cu",
        "replaces": "src/repro/kernels/trie_walk/trie_walk.py:55",
        "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    })
    return out


def _serve(bank, trie, queries, layout, **kw):
    """One fresh server answering ``queries`` from a cold cache (its
    row cache and the process-wide fingerprint memo both empty):
    (rows, stats, wall)."""
    import numpy as np
    import torch

    from repro_torch.serving.bank import sequence_fingerprint
    from repro_torch.serving.server import PatternServer

    sequence_fingerprint.cache_clear()
    srv = PatternServer(bank, device="cuda", max_batch=MAX_BATCH,
                        bank_layout=layout, trie=trie, **kw)
    t0 = time.perf_counter()
    got = srv.query(queries)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return np.stack([r.contained for r in got]), dict(srv.stats), wall


def _log_layer_times(bank, trie, queries, layout):
    """Host time by serving layer from one fully traced run: every span
    of ``repro_torch.obs.trace`` summed by name.  Under full tracing each
    device call is fenced (``torch.cuda.synchronize``), so ``<name>`` is
    its launch and ``<name>.device`` the wait for the device; the run is
    slower than an untraced one by those fences."""
    from repro_torch.obs import trace

    trace.clear()
    trace.enable()
    try:
        _, _, wall = _serve(bank, trie, queries, layout, emax=EMAX)
    finally:
        trace.disable()
    by = {}
    for ev in trace.tracer.events:
        tot, n = by.get(ev["name"], (0.0, 0))
        by[ev["name"]] = (tot + ev["dur"] / 1e3, n + 1)
    trace.clear()
    log(f"[trace serving {layout}] traced wall {wall:.3f}s; ms by span: "
        + "; ".join(f"{k} {v:.3f}/{n}" for k, (v, n) in
                    sorted(by.items(), key=lambda kv: -kv[1][0])))


def phase_serving(setup) -> dict:
    """The slice's main path: three layouts over the 211-rFTS bank, the
    launch counts zeroed just before and read just after."""
    import numpy as np
    import torch

    from repro_torch.core.containment import contains
    from repro_torch.kernels.containment import ops as cops
    from repro_torch.kernels.trie_walk import ops as wops
    from repro_torch.serving import batch

    bank, trie, queries = setup["bank"], setup["trie"], setup["queries"]
    cops.launches = wops.launches = 0
    batch.predicate_calls = batch.fused_walks = 0
    rows, walls, stats = {}, {}, {}
    for layout in LAYOUTS:
        rows[layout], stats[layout], walls[layout] = _serve(
            bank, trie, queries, layout, emax=EMAX)
    launches = {"contain_step": cops.launches, "trie_walk": wops.launches}
    calls = {"contain_step": batch.predicate_calls,
             "trie_walk": batch.fused_walks}
    for layout in LAYOUTS:
        log(f"[serving] {layout}: {len(queries)} queries in "
            f"{walls[layout]:.3f}s ({len(queries) / walls[layout]:.1f} "
            f"qps), {int(rows[layout].sum())} containments, "
            f"stats={stats[layout]}")
    for layout in LAYOUTS[1:]:
        if not np.array_equal(rows[layout], rows["flat"]):
            raise AssertionError(
                f"{layout} rows differ from flat in "
                f"{int((rows[layout] != rows['flat']).sum())} cells")
    fused_batches = stats["trie_fused"]["device_batches"]
    if not (launches["contain_step"] > 0
            and launches["contain_step"] == calls["contain_step"]):
        raise AssertionError(
            f"contain_step launched {launches['contain_step']} times for "
            f"{calls['contain_step']} predicate calls")
    if not (launches["trie_walk"] > 0
            and launches["trie_walk"] == calls["trie_walk"]
            <= fused_batches):
        raise AssertionError(
            f"trie_walk launched {launches['trie_walk']} times for "
            f"{calls['trie_walk']} fused walks ({fused_batches} batches)")
    log(f"[serving] launches on the main path: contain_step "
        f"{launches['contain_step']} (== predicate calls), trie_walk "
        f"{launches['trie_walk']} (== fused walks, {fused_batches} fused "
        f"batches)")

    t0 = time.perf_counter()
    sub = queries[:N_ORACLE]
    want = np.array([[contains(p, s) for p in bank.patterns] for s in sub])
    if not np.array_equal(rows["flat"][:N_ORACLE], want):
        raise AssertionError(
            f"served rows differ from the host oracle in "
            f"{int((rows['flat'][:N_ORACLE] != want).sum())} of "
            f"{want.size} cells")
    log(f"[serving] rows == host oracle on the first {N_ORACLE} queries x "
        f"{bank.n_patterns} patterns ({int(want.sum())} containments; "
        f"oracle {time.perf_counter() - t0:.2f}s)")

    # frontier capacity 1 with a retry at 2: undecided cells escalate
    # and the ones still undecided fall back to the host oracle
    for layout in LAYOUTS:
        got, st, wall = _serve(bank, trie, queries, layout, emax=1,
                               emax_retry=2)
        if not np.array_equal(got, rows["flat"]):
            raise AssertionError(
                f"{layout} at emax=1 differs in "
                f"{int((got != rows['flat']).sum())} cells")
        if not (st["escalated_cells"] > 0 and st["host_fallback_cells"] > 0):
            raise AssertionError(f"{layout} at emax=1 did not escalate "
                                 f"and fall back: {st}")
        log(f"[serving] {layout} emax=1 emax_retry=2: rows equal; "
            f"escalated {st['escalated_cells']}, host fallback "
            f"{st['host_fallback_cells']} cells; wall {wall:.3f}s")

    for layout in LAYOUTS:
        _log_layer_times(bank, trie, queries, layout)
    from torch.profiler import ProfilerActivity, profile

    for layout in LAYOUTS:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _serve(bank, trie, queries, layout, emax=EMAX)
            torch.cuda.synchronize()
        _log_device_times(f"[profile serving {layout}]", prof,
                          time.perf_counter() - t0, walls[layout], top_n=8)
    return launches


def phase_serve_launcher() -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    for extra in ([], ["--emax", "1"]):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cuda", "--bank-layout", "trie_fused", *extra],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            log(f"  {line}")
        if proc.returncode != 0 or "(verified)" not in proc.stdout:
            raise AssertionError(
                f"serve launcher {extra} failed ({proc.returncode}):\n"
                f"{proc.stderr[-4000:]}")
        log(f"[launcher] serve --bank-layout trie_fused {' '.join(extra)} "
            f"on cuda verified in {time.perf_counter() - t0:.2f}s")


def phase_launcher() -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.mine", "--algo", "both",
         "--device", "cuda"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=900)
    for line in proc.stdout.splitlines():
        log(f"  {line}")
    if proc.returncode != 0 or "(verified)" not in proc.stdout:
        raise AssertionError(
            f"launcher --algo both failed ({proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    log(f"[launcher] --algo both on cuda verified in "
        f"{time.perf_counter() - t0:.2f}s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: {SRC}/repro_torch not found; run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, SRC)
    t_start = time.perf_counter()
    log(_gpu_line())
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    phase_build()
    kernels = [phase_match_count()]
    launches, res = phase_main_path()
    phase_launcher()
    setup = serving_setup(res)
    kernels += phase_serving_kernels(setup)
    launches.update(phase_serving(setup))
    phase_serve_launcher()

    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["status"] = "ok"
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
