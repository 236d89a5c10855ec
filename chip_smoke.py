#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero before the last
line) on any failure:

1. card and build: prints the card's name and power limit, builds every
   kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per source, all
   started together) and prints the build times;
2. match_count vs its plain PyTorch version, on the card: bit-equality
   in both forms on random inputs at the main path's widths and on the
   edge existing tables and pid layouts of the tests
   (``tests/scan_inputs.py``) over E in 1/5/37/129/1024 x T in
   1/31/32/33/64/300 and at the tests' other widths (NI, NV, P), then
   timings (CUDA events) of the kernel and the plain version beside the
   kernel's bound;
3. the main path: ``AcceleratedMiner(device="cuda").mine_rs`` on the
   paper's Table 3 default DB (1000 sequences, seed 0, sigma 100,
   max_len 6), held to the port's host oracle
   ``repro_torch.core.reverse_search.mine_gtrace_rs``; the launch counts
   are zeroed just before and read just after, and every kernel of the
   path must have launched, once per device call; a second, profiled run
   reports the device time by kernel; a third records the arguments of
   the run's first full 1024-row scan, on which match_count is held to
   its plain version and timed beside its bound;
4. the launcher's ``--algo both`` self-check on ``cuda`` at its default
   size (GTRACE.relevant() == GTRACE-RS);
5. the serving kernels vs their plain versions on the card: contain_step
   on random inputs, at its edge shapes (Ein*Tm of 1, 8, 31, 33 and 512
   over cell counts that no block size divides) on inputs past the
   cheap gates where every mask value occurs, and on the real inputs of
   one flat serving batch; trie_walk, through the entry that
   reads the tables in place by cell, on the Table 3 bank's packed
   subtrees against the first 512 queries, and on the same tables at
   emax 1 / tmax 1 and emax 16 / tmax 32, over a batch of pad cells,
   with 25 % of the slots forced to ``REQ_MASKED``, and with step keys,
   itemset slots and pattern vertices out of range
   (``tests/gather_inputs.py``); bit-equality, then timings beside each
   kernel's bound;
6. the serving path: ``PatternServer(device="cuda")`` over the bank of
   phase 3's map (211 rFTSs) answers 1000 Table 3 queries (seed 1)
   under the ``flat``, ``trie`` and ``trie_fused`` layouts; the rows
   are equal across layouts, to the host oracle
   ``repro_torch.core.containment.contains`` on the first 128 queries,
   and again at ``emax=1`` (escalation and host fallback); the launch
   counts are zeroed just before and read just after, and both serving
   kernels must have launched once per predicate call / fused walk; a
   profiled repeat per layout reports the device time by kernel (the
   port's three kernels always by name), and a timed trie_fused run the
   device time from start to end of each fused walk;
7. the serving launcher on ``cuda`` (``--bank-layout trie_fused``, at
   its defaults, at ``--emax 1``, and in its streaming, replica,
   cluster and sharded-window modes), each run checking itself;
8. the streaming window: phase 3's DB seeds a ``StreamingBank`` of
   window 1000 under each layout, the 1000 queries stream in as
   arrivals in batches of 50 (``refresh_every`` 4, ``compact_threshold``
   0.5, a closing full refresh), every refresh is held to a batch
   re-mine of the window on the card, the layouts end on one map equal
   to the host oracle, and the launch counts, zeroed after the seed and
   read after the stream, equal the bank's device calls (the checks'
   re-mines counted apart); latency percentiles and a profiled
   refresh's device-busy share are printed;
9. the simulated cluster: 4 hosts on the one card route (sync and
   async) the 1000 queries under each layout, equal to the single-host
   rows; a seeded fault schedule with one host dark answers every query
   exactly or as a flagged superset; a 4-host sharded window replays
   phase 8's stream and ends each refresh on its map; two read replicas
   serve through a writer refresh, converge, and a crashed one replays
   the recovery log;
10. the multi-rank steps (``repro_torch.mining.distributed``,
   ``repro_torch.serving.sharded``) on the one card: 8 spawned ranks of
   a gloo world share ``cuda:0`` on a 4 data x 2 model mesh; the mining
   step (k 4096, both ``prededup`` modes) runs the root scan and every
   pattern scan of a recorded Table 3 mine (the DB encoded to T = 34,
   each scan's rows regrouped by DB shard), each equal on every rank to
   the single-device ``candidate_table_device`` of the same scan made by
   match_count's plain version on the card, which equals
   ``aggregate_host``; the flat and trie serving steps over the bank of
   phase 3's map (padded to an even row count; the trie in 2 shards)
   join the 1000 queries (250 a data rank, emax 4), equal to the
   single-rank joins through contain_step's plain version on the card,
   which equal the host oracle on the first 128 queries where no cell
   overflowed; each rank's match_count launches equal its mining steps
   and its contain_step launches its predicate calls; after the counts
   are read, each rank holds match_count to its plain version on its
   block of every scan it stepped, and contain_step to its plain
   version on every call of one more serving step a layout; then one
   rank of NCCL (a 1x1 mesh) runs the root scan's mining step (without
   ``prededup``: one rank's pairs pass its k slots) and the flat
   serving step under the same checks, each repeated for its wall;
   walls per step and per-rank errors printed, the errors also folded
   into the kernels' ``max_abs_err``;
11. the LM family (``repro_torch.models``, ``training``, ``configs``;
   no TPU kernel lies on it, its products are plain matmuls), fp32
   products in full fp32: blockwise == naive attention at smollm-135m's
   heads; smollm-135m at full width (134.5M params) takes the arch's
   train step 4 times at seq 4096, batch 8 (step 1's loss and gradient
   norm at bf16 within 2e-2 of fp32 compute), 2 more through
   ``train_loop.train`` with grad_accum 2 and async checkpoints
   (restored bit-equal), prefills at seq 32768 (batch 1) and decodes 32
   tokens at batch 16 on a 32768-slot cache, and decode equals forward
   + logits over 64 tokens at fp32 (2e-4); olmoe-1b-7b's MoE layer on
   4096 tokens equals a per-expert loop (1e-4, the same dropped routes)
   and the whole model (6.92B fp32 params) prefills 2048 tokens; the
   five LM smoke configs' train step on cuda is held to the CPU's; the
   train launcher on cuda learns in 100 steps; an attention yardstick
   (blockwise vs ``scaled_dot_product_attention``) is printed only;
12. one JSON line describing every ported kernel, then the last line
   ``{"ok": true, "device": {...}}``.

It needs a CUDA device and the repository around it: without either it
exits non-zero and prints no result.  It imports nothing of JAX or of
the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# HBM3 bandwidth of the H100 SXM (NVIDIA data sheet, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
# 32-bit integer operations (add, compare, min/max, logic) an SM issues a
# clock at compute capability 9.0, from the CUDA C++ Programming Guide's
# table of arithmetic instruction throughput: half the FP32 lanes.  The
# kernels' int32 peak is this times the card's SMs and its maximum SM
# clock, set in main() (16.7e12 ops/s at 132 SMs and 1,980 MHz).
INT32_OPS_PER_SM_CLOCK = 64
PEAK_OPS_PER_S = None

# the main path's scan shapes (AcceleratedMiner defaults on the Table 3
# DB): e_batch 1024, max_itemsets 16, max_vertices 12, MAX_PATTERN_TRS
# 64, wave_patterns 256; T = 33 tokens per sequence
G, T, NI, NV, P, NP = 1000, 33, 16, 12, 64, 256
# match_count's edge sweep: rows per block of 1 to 32, a block of one
# row wider than 256 threads, and a ragged last block
EDGE_E = (1, 5, 37, 129, 1024)
EDGE_T = (1, 31, 32, 33, 64, 300)
# the (E, T) of match_count's cases at the tests' other widths
WIDTH_SHAPES = ((1, 1), (37, 33), (129, 31), (5, 300))
# csrc sources, one nvcc each, all built together
KERNELS = ("match_count", "containment", "trie_walk")
# the serving phase: Table 3 queries (seed 1) against phase 3's bank
N_QUERIES, MAX_BATCH, EMAX, N_ORACLE = 1000, 512, 4, 128
LAYOUTS = ("flat", "trie", "trie_fused")
# cold serving passes timed after the counted one, each layout
SERVE_REPS = 6
# the streaming phase: phase 3's DB as the window, the queries streamed
# in as arrivals; the cluster phase's simulated hosts
STREAM_BATCH, REFRESH_EVERY, COMPACT, N_HOSTS = 50, 4, 0.5, 4
# the multi-rank phase: 8 gloo ranks on the one card, DIST_DB data x
# DIST_MODEL model; T = 33 padded to 34 so that it splits over "model";
# the mining step's k; the scans of the first DIST_PROBE steps estimate
# the phase's mining time, and past DIST_BUDGET_S only the first
# DIST_CUT scans run; serving steps timed after the counted one
DIST_DB, DIST_MODEL, DIST_PAD_T, DIST_K = 4, 2, 34, 4096
DIST_PROBE, DIST_CUT, DIST_BUDGET_S = 16, 64, 120.0
DIST_SERVE_REPS, DIST_TIMEOUT_S = 3, 600.0
# contain_step's random (G, Ein, Tm) cases; its edge shapes are the
# tests' EDGE_SHAPES (tests/contain_inputs.py)
CONTAIN_RANDOM = ((1, 1, 1), (65, 4, 9), (4096, 4, 16), (4096, 16, 16))
# the port's kernels as the profiler names them
PORT_KERNELS = ("contain_step_kernel", "trie_walk_kernel",
                "match_count_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _int32_peak() -> float:
    """The card's int32 peak in ops/s: INT32_OPS_PER_SM_CLOCK x its SMs x
    its maximum SM clock (nvidia-smi, MHz)."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_OPS_PER_SM_CLOCK * sms * mhz * 1e6


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


def _bound_ms(args):
    """Least time for one scan on these inputs: the bytes it must move
    (the gathered token and existing rows it references, the per-row
    and per-pattern inputs, the output) over HBM bandwidth, against the
    int32 operations these inputs need over the 32-bit peak.  Returns
    the bound, what bounds it, the bytes, the operations, and the
    operations as PR 11-13 counted them (the duplicate check over all P
    rows of a table, padding included)."""
    import torch

    from repro_torch.kernels import gather_index

    tokens, gid, phi, psi, valid, pid, ex, nv, npat, modes = args
    T_ = tokens.shape[1]
    E, NI_ = phi.shape
    NV_ = psi.shape[1]
    P_ = ex.shape[1]
    g = gather_index(gid, tokens.shape[0])
    p = gather_index(pid, ex.shape[0])
    n_g = int(torch.unique(g).numel())
    n_p = int(torch.unique(p).numel())
    nbytes = 4 * (n_g * T_ * 6 + n_p * P_ * 5 + E * (NI_ + NV_ + 3)
                  + 3 * n_p + E * T_)
    tok = tokens[g]                                 # [E,T,6]
    active = (tok[..., 5] > 0) & (valid[:, None] > 0)
    in_any = (phi[:, None, :] == tok[..., 4:5]).any(-1) & active
    # per active pair: two psi lookups, the phi position and gap count,
    # ~30 scalar ops (gates, slot, packing); the duplicate check, only
    # for in-itemset slots, 5 compares per row of the pattern's table
    # that can match (itemset field >= 0: the slot is)
    real = (ex[..., 0] >= 0).sum(-1)[p]             # [E]
    base = int(active.sum()) * (2 * NV_ + 2 * NI_ + 30)
    ops = base + 5 * int((in_any.sum(-1) * real).sum())
    ops_all_rows = base + int(in_any.sum()) * 5 * P_
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_OPS_PER_S
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations",
            nbytes, ops, ops_all_rows)


def _time_match_count(what, args, reps, plain_reps):
    """Time match_count and its plain version on ``args`` (CUDA
    events) and log both beside the bound: (ms, plain_ms, bound)."""
    from repro_torch.kernels.match_count import ops, ref

    ms, host_ms = _time_ms(lambda: ops.match_signatures_batch(*args),
                           reps=reps)
    plain_ms, plain_host_ms = _time_ms(
        lambda: ref.match_signatures_batch_ref(*args), reps=plain_reps)
    bound = _bound_ms(args)
    E_, T_ = args[2].shape[0], args[0].shape[1]
    log(f"[match_count] {what} E={E_} T={T_}: kernel {ms:.5f} ms device "
        f"(median), {host_ms:.5f} ms per wrapper call on the host; plain "
        f"{plain_ms:.5f} ms device, {plain_host_ms:.5f} ms host; bound "
        f"{bound[0]:.6f} ms by {bound[1]} ({bound[2]} B, {bound[3]} int "
        f"ops over the tables' rows that can match; {bound[4]} counted "
        f"over all {args[6].shape[1]} rows); library_ms null (no single "
        f"PyTorch call computes this)")
    return ms, plain_ms, bound


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

    # the edge tables and pid layouts of the tests, both forms, at the
    # main path's widths over the edge sweep and at the tests' other
    # widths over a few shapes
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from scan_inputs import PIDS, TABLES, WIDTHS, scan_inputs

    cases = [(10 + TABLES.index(tables), tables, NI, NV, P,
              [(E, T_) for E in EDGE_E for T_ in EDGE_T])
             for tables in TABLES]
    cases += [(100 + 7 * WIDTHS.index(w) + TABLES.index(tables), tables,
               *w, WIDTH_SHAPES) for w in WIDTHS for tables in TABLES]
    n_cmp = 0
    for seed, tables, NI_, NV_, P_, shapes in cases:
        rng = np.random.default_rng(seed)
        for i, (E, T_) in enumerate(shapes):
            pids = PIDS[i % len(PIDS)]
            NP_ = 1 if pids == "one" else 64
            arrays = scan_inputs(rng, E, 40, T_, NI_, NV_, P_, NP_,
                                 tables=tables, pids=pids)
            modes = rng.integers(0, 4, (NP_,)).astype(np.int32)
            args = [torch.from_numpy(a).to(dev) for a in (*arrays, modes)]
            tokens, gid, phi, psi, valid, _, ex = args[:7]
            scal = (int(arrays[7][0]), int(arrays[8][0]), int(modes[0]))
            for form, got, want in (
                    ("per-row", ops.match_signatures_batch(*args),
                     ref.match_signatures_batch_ref(*args)),
                    ("scalar", ops.match_signatures_kernel(
                        tokens, gid, phi, psi, valid, ex[0], *scal),
                     ref.match_signatures_ref(
                        tokens, gid, phi, psi, valid, ex[0], *scal))):
                torch.cuda.synchronize()
                max_err = max(max_err, _abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"match_count {form} tables={tables} pids={pids} "
                        f"NI={NI_} NV={NV_} P={P_} E={E} T={T_}: "
                        f"{int((got != want).sum())} signatures differ")
                n_cmp += 1
    log(f"[match_count] bit-equal to the plain version in {n_cmp} more "
        f"comparisons: tables {'/'.join(TABLES)} x E in "
        f"{'/'.join(map(str, EDGE_E))} x T in {'/'.join(map(str, EDGE_T))}"
        f" at NI={NI}, NV={NV}, P={P}, and x (E, T) in {WIDTH_SHAPES} at "
        f"(NI, NV, P) in {WIDTHS}; pid layouts {'/'.join(PIDS)} in turn, "
        f"per-row + scalar")

    args = [torch.from_numpy(a).to(dev)
            for a in _scan_inputs(np.random.default_rng(1), 1024, None)]
    ms, plain_ms, (bound_ms, bound_by, *_) = _time_match_count(
        "random inputs", args, reps=200, plain_reps=10)
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
    return launches, res, _record_chunk(db, sigma, max_len)


def _record_chunk(db, sigma, max_len):
    """The arguments of one full 1024-row scan of a third run of the
    Table 3 mining, recorded as ``serving_setup`` records the serving
    kernels' calls: of the scans whose 1024 rows are all valid, the
    first that spans the most patterns (the deepest waves: up to 11
    patterns and 5 real rows a table)."""
    from repro_torch.mining import driver
    from repro_torch.mining.driver import AcceleratedMiner

    orig = driver.match_signatures_batch
    chunks = []

    def record(*args):
        pid = args[5]
        if args[1].shape[0] == 1024 and bool((args[4] > 0).all()):
            runs = int((pid[1:] != pid[:-1]).sum()) + 1
            if not chunks or runs > chunks[0][0]:
                chunks[:] = [(runs, [a.clone() for a in args])]
        return orig(*args)

    driver.match_signatures_batch = record
    try:
        AcceleratedMiner(db, device="cuda").mine_rs(sigma, max_len=max_len)
    finally:
        driver.match_signatures_batch = orig
    if not chunks:
        raise AssertionError("the Table 3 run made no full 1024-row scan")
    return chunks[0][1]


def phase_match_count_chunk(chunk) -> int:
    """match_count on the recorded Table 3 chunk: bit-equal to its plain
    version, then timed beside its bound.  Returns the largest absolute
    difference (0)."""
    import torch

    from repro_torch.kernels.match_count import ops, ref

    got = ops.match_signatures_batch(*chunk)
    want = ref.match_signatures_batch_ref(*chunk)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"match_count on the Table 3 chunk: "
                             f"{int((got != want).sum())} signatures differ")
    pid = chunk[5]
    log(f"[match_count] Table 3 chunk: bit-equal to the plain version "
        f"({int((want >= 0).sum())} signatures; "
        f"{int(torch.unique(pid).numel())} patterns over 1024 rows, "
        f"{int((pid[1:] != pid[:-1]).sum()) + 1} runs; tables of "
        f"{chunk[6].shape[0]} x {chunk[6].shape[1]} rows, at most "
        f"{int((chunk[6][..., 0] >= 0).sum(-1).max())} real)")
    _time_match_count("Table 3 chunk", chunk, reps=200, plain_reps=10)
    return _abs_err(got, want)


def _log_device_times(tag, prof, prof_wall, wall, top_n=6, port=True):
    """Device time by kernel and copy from a profiler run (device
    activity only), and the device-busy share of the unprofiled
    ``wall``; with ``port``, the port's kernels by name."""
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
    if dev and port:
        log(f"{tag} port kernels: " + "; ".join(
            "{} {:.5f} ms / {}".format(name, *_named_sum(dev, name))
            for name in PORT_KERNELS))
    if not dev:
        log(f"{tag} the profiler recorded no device time: not measured")


def _named_sum(dev, name):
    """(device ms, launches) summed over the profiler keys that hold
    ``name`` (a kernel's key is its full signature)."""
    hits = [v for k, v in dev.items() if name in k]
    return sum(v for v, _ in hits) / 1e3, sum(n for _, n in hits)


def _bound(nbytes, nops):
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * nops / PEAK_OPS_PER_S
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _gates(tok, srow):
    """[G,Ein,Tm] bool: the (cell, row, token) pairs past the predicate's
    cheap validity, type, label and itemset-slot gates."""
    t = tok[:, None, :, :]
    r = srow[:, :, None, :]
    return ((t[..., 5] > 0) & (r[..., 7] > 0) & (t[..., 0] == r[..., 0])
            & (t[..., 3] == r[..., 3])
            & ((r[..., 4] > 0) & (t[..., 4] > r[..., 5])
               | (r[..., 4] <= 0) & (t[..., 4] == r[..., 6])))


def _contain_bound(tok, psi, srow):
    """Least time for one contain_step call: each input read once and
    the output written once over HBM bandwidth, against the int32
    operations these inputs need (about 10 per (cell, row, token) pair
    for the type/label/slot gates, and 3 NV + 20 more for the psi
    lookups and orientation tests of the pairs that pass them)."""
    G_, Tm, _ = tok.shape
    _, E_, NV_ = psi.shape
    nbytes = 4 * (tok.numel() + psi.numel() + srow.numel() + G_ * E_ * Tm)
    nops = G_ * E_ * Tm * 10 + int(_gates(tok, srow).sum()) * (3 * NV_ + 20)
    return (*_bound(nbytes, nops), nbytes, nops)


def _real_cells(cells):
    """The rows of a fused batch's ``cells [npad, 2]`` that name a real
    (sequence, subtree) cell.  The server fills the first n rows from
    ``np.nonzero`` (unique, ascending) and pads with (0, 0), so a (0, 0)
    row past the first is padding."""
    return cells[:1 + int((cells[1:] != 0).any(dim=1).sum())]


def _walk_work(args, kw):
    """What this call's data needs of the join, read off the plain
    version's predicate calls (one per slot, over the cells' seed rows):
    the slots that join (a valid seed row and a valid step, so a window
    to gather), their (seed row, token) pairs over the valid seed rows
    only (a root slot has one row, a slot under a dead or empty parent
    none), of those the pairs that pass the cheap gates, and the
    frontier rows kept.  A cell's pairs past its (emax+1)-th candidate
    are not counted: the walk is decided there."""
    import torch

    from repro_torch.kernels.trie_walk import ref as wref

    E = kw["emax"]
    work = {"joined": 0, "pairs": 0, "gated": 0, "kept": 0}
    orig = wref.contain_step_core

    def record(tok_w, psi, srow):
        bits = orig(tok_w, psi, srow)
        N, Ein, Tm = bits.shape
        valid = (srow[..., 7] > 0)[..., None].expand(N, Ein, Tm)
        flags = ((bits & 1) + ((bits >> 1) & 1)).reshape(N, -1)
        before = torch.cumsum(flags, -1) - flags
        need = valid.reshape(N, -1) & (before <= E)
        work["joined"] += int((srow[..., 7] > 0).any(-1).sum())
        work["pairs"] += int(need.sum())
        work["gated"] += int((_gates(tok_w, srow).reshape(N, -1)
                              & need).sum())
        work["kept"] += int(flags.sum(-1).clamp(max=E).sum())
        return bits

    wref.contain_step_core = record
    try:
        _plain_walk(args, kw)
    finally:
        wref.contain_step_core = orig
    return work


def _walk_bound(args, emax, tmax, ni, nv):
    """Least time for one trie_walk call over the batch's real cells:
    their cell indices, each sequence's token table and index rows and
    each subtree's packed tables read once, both byte outputs of the
    real cells written once, against the int32 operations this data
    needs (``_walk_work``): the K-wide prescreen of every slot; for
    each slot that joins, the window gather (8 a token); 10 a pair over
    the valid seed rows for the gates, 3 nv + 20 more for each pair past
    them and 2 for its ballot rank; and ni + nv updates of 3 ops for
    each kept row."""
    import torch

    kw = dict(emax=emax, tmax=tmax, ni=ni, nv=nv)
    real = _real_cells(args[4])
    args = [*args[:4], real, *args[5:]]
    tokens, order, start, count, cells, steps_s, parent_s, req_s = args
    T = tokens.shape[1]
    _, S, K = req_s.shape
    n = real.shape[0]
    n_seq = int(torch.unique(real[:, 0]).numel())
    n_sub = int(torch.unique(real[:, 1]).numel())
    nbytes = (4 * (2 * n + n_seq * (7 * T + 2 * K) + n_sub * S * (9 + K))
              + 2 * n * S)
    work = _walk_work(args, kw)
    nops = (n * S * K + work["joined"] * tmax * 8 + work["pairs"] * 12
            + work["gated"] * (3 * nv + 20) + work["kept"] * 3 * (ni + nv))
    return (*_bound(nbytes, nops), nbytes, nops, n, work)


def _plain_walk(args, kw):
    """The plain version of ``trie_walk_cells`` on the card: the tables
    gathered by cell, then ``ref.trie_walk_core``."""
    from repro_torch.kernels.trie_walk import ref as wref

    tokens, order, start, count, cells, steps_s, parent_s, req_s = args
    b, s = cells[:, 0].long(), cells[:, 1].long()
    return wref.trie_walk_core(tokens[b], order[b], start[b], count[b],
                               steps_s[s], parent_s[s], req_s[s], **kw)


def _abs_err(got, want) -> int:
    """Largest absolute difference of two integer or bool tensors."""
    if got.numel() == 0:
        return 0
    return int((got.long() - want.long()).abs().max())


def serving_setup(res) -> dict:
    """Phase 3's map compiled into the serving bank, its trie, the 1000
    Table 3 queries (seed 1), and the real inputs of the serving
    kernels: one flat batch's contain_step calls and one fused batch's
    trie_walk_cells call (its tables and cells), recorded while a
    server answers the first ``MAX_BATCH`` queries."""

    from repro_torch.data.synthetic import Table3Params, generate_table3_db
    from repro_torch.serving import batch
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
    recorded = {"contain_step": [], "trie_walk_cells": []}
    orig = {name: getattr(batch, name) for name in recorded}

    def recorder(name):
        def call(*args, **kw):
            recorded[name].append(
                ([a.clone() for a in args], dict(kw)))
            return orig[name](*args, **kw)
        return call

    for name in recorded:
        setattr(batch, name, recorder(name))
    try:
        first = queries[:MAX_BATCH]
        for layout in ("flat", "trie_fused"):
            srv = PatternServer(bank, device="cuda", max_batch=MAX_BATCH,
                                emax=EMAX, bank_layout=layout, trie=trie)
            srv.query(first)
            if layout == "flat":
                flat_calls = list(recorded["contain_step"])
    finally:
        for name, fn in orig.items():
            setattr(batch, name, fn)
    if not flat_calls or len(recorded["trie_walk_cells"]) != 1:
        raise AssertionError(
            f"recorded {len(flat_calls)} contain_step calls of the flat "
            f"batch and {len(recorded['trie_walk_cells'])} fused walks")
    return {"bank": bank, "trie": trie, "queries": queries,
            "flat_calls": flat_calls,
            "walk": recorded["trie_walk_cells"][0]}


def phase_serving_kernels(setup) -> list:
    import numpy as np
    import torch

    from repro_torch.kernels.containment import ops as cops
    from repro_torch.kernels.containment import ref as cref
    from repro_torch.kernels.trie_walk import ops as wops
    from repro_torch.kernels.trie_walk import ref as wref

    # the random inputs of the port's contain_step tests
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from contain_inputs import EDGE_SHAPES, contain_inputs, matching_inputs
    from gather_inputs import FIELDS, out_of_range_steps

    dev = torch.device("cuda")
    out = []
    # ---- contain_step: random inputs, then the flat batch's real calls
    rng = np.random.default_rng(2)
    n_cmp = max_err = 0
    # the edge shapes on inputs past the cheap gates, where every mask
    # value must occur
    cases = ([(contain_inputs, c) for c in CONTAIN_RANDOM]
             + [(matching_inputs, c) for c in EDGE_SHAPES])
    for make, (G_, E_, Tm) in cases:
        args = [torch.from_numpy(a).to(dev)
                for a in make(rng, G_, E_, Tm, 6)]
        got = cops.contain_step(*args)
        want = cref.contain_step_core(*args)
        torch.cuda.synchronize()
        max_err = max(max_err, _abs_err(got, want))
        if not torch.equal(got, want):
            raise AssertionError(
                f"contain_step random G={G_} Ein={E_} Tm={Tm}: "
                f"{int((got != want).sum())} masks differ")
        if make is matching_inputs and \
                set(torch.unique(want).tolist()) != {0, 1, 2, 3}:
            raise AssertionError(
                f"contain_step edge shape G={G_} Ein={E_} Tm={Tm}: mask "
                f"values {torch.unique(want).tolist()}, not all of 0-3")
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
        f"comparisons: random (G,Ein,Tm) in "
        + "/".join(f"({g},{e},{t})" for g, e, t in CONTAIN_RANDOM)
        + ", edge shapes past the gates (every mask value occurring) in "
        + "/".join(f"({g},{e},{t})" for g, e, t in EDGE_SHAPES)
        + f" at NV=6, and all {len(flat_calls)} predicate calls "
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

    # ---- trie_walk: the fused batch's real call, then edge cases
    args, kw = setup["walk"]
    cells = args[4]
    N = cells.shape[0]
    _, S, K = args[7].shape
    max_err = 0
    n_cmp = 0

    def held(what, args, kw):
        nonlocal max_err, n_cmp
        got = wops.trie_walk_cells(*args, **kw)
        want = _plain_walk(args, kw)
        torch.cuda.synchronize()
        for g, w, name in zip(got, want, ("acc", "ovf_term")):
            max_err = max(max_err, _abs_err(g, w))
            if not torch.equal(g, w):
                raise AssertionError(f"trie_walk {what} {name}: "
                                     f"{int((g != w).sum())} bits differ")
        n_cmp += 1
        return want

    want = held("fused batch", args, kw)
    n_acc = int(want[0].sum())
    edges = {}
    for what, ekw in (("emax 1 / tmax 1", dict(kw, emax=1, tmax=1)),
                      ("emax 16 / tmax 32", dict(kw, emax=16, tmax=32))):
        edges[what] = int(held(what, args, ekw)[0].sum())
    pads = [*args[:4], torch.zeros((N, 2), dtype=torch.int32, device=dev),
            *args[5:]]
    acc_p, ovf_p = held("pad cells", pads, kw)
    if not ((acc_p == acc_p[:1]).all() and (ovf_p == ovf_p[:1]).all()):
        raise AssertionError("pad cells walked differently")
    masked = [a.clone() for a in args]
    kill = torch.from_numpy(np.random.default_rng(3).random(
        tuple(args[7].shape[:2])) < 0.25).to(dev)
    masked[7][kill] = wref.REQ_MASKED
    acc_m, ovf_m = held("25 % REQ_MASKED", masked, kw)
    dead = kill[cells[:, 1].long()]
    if (acc_m & dead).any() or (ovf_m & dead).any():
        raise AssertionError("a REQ_MASKED slot came out set")
    # step keys, itemset slots and pattern vertices out of range (-1,
    # -(n+3), n, n+7; tests/gather_inputs.py): all four fields in turn
    # over every third real slot, then every real slot's key at a window
    # of one (no window opens: nothing accepted), then every slot's idx
    oor = {}
    for fields, every, tmax in ((tuple(FIELDS), 3, kw["tmax"]),
                                (("key",), 1, 1), (("idx",), 1, kw["tmax"])):
        steps, n_bad = out_of_range_steps(
            args[5].cpu().numpy(), K=K, ni=kw["ni"], nv=kw["nv"],
            fields=fields, every=every)
        bad = [*args[:5], torch.from_numpy(steps).to(dev), *args[6:]]
        what = f"out-of-range {'/'.join(fields)} (tmax {tmax})"
        oor[what] = (n_bad, int(held(what, bad, dict(kw, tmax=tmax))[0]
                                .sum()))
    if oor["out-of-range key (tmax 1)"][1]:
        raise AssertionError("a slot whose step key is out of range "
                             "accepted")
    log(f"[trie_walk] bit-equal to the plain version in {n_cmp} "
        f"comparisons, through trie_walk_cells: the fused batch of "
        f"{MAX_BATCH} queries (N={N} cells, S={S} slots, K={K}, "
        f"T={args[0].shape[1]}, {kw}; {n_acc} accepted slots); the same "
        f"cells at " + ", ".join(f"{k} ({v} accepted)"
                                 for k, v in edges.items())
        + f"; {N} pad cells; {int(dead.sum())} of {dead.numel()} cell "
        f"slots forced to REQ_MASKED ({int(acc_m.sum())} accepted); "
        + ", ".join(f"{k}: {n} of the {args[5].shape[0]} subtrees' slot "
                    f"rows changed, {a} accepted"
                    for k, (n, a) in oor.items()))
    ms, host_ms = _time_ms(lambda: wops.trie_walk_cells(*args, **kw),
                           reps=100)
    plain_ms, plain_host_ms = _time_ms(lambda: _plain_walk(args, kw),
                                       reps=5)
    bound_ms, bound_by, nbytes, nops, n_real, work = _walk_bound(args,
                                                                 **kw)
    log(f"[trie_walk] N={N} cells ({n_real} real) S={S}: kernel {ms:.5f} "
        f"ms device (median, reading the tables in place by cell), "
        f"{host_ms:.5f} ms per wrapper call on the host; plain "
        f"{plain_ms:.5f} ms device (gathers included), {plain_host_ms:.5f}"
        f" ms host; bound {bound_ms:.6f} ms by {bound_by} ({nbytes} B of "
        f"cell indices, distinct sequence and subtree tables and byte "
        f"outputs; {nops} int ops over {work['joined']} joining slots, "
        f"{work['pairs']} pairs over valid seed rows, {work['gated']} past "
        f"the gates, {work['kept']} rows kept; int32 peak "
        f"{PEAK_OPS_PER_S:.4g} ops/s); library_ms null (no single PyTorch "
        f"call computes this)")
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


def _log_fused_walk_device(bank, trie, queries):
    """Device time from the start to the end of every fused walk of one
    trie_fused run, on CUDA events recorded around
    ``fused_trie_walk``: whatever it enqueues (any gathers in front of
    the kernel, the kernel, the bool casts after it).  Each walk is
    queued behind a device sleep longer than the host needs to enqueue
    it, so the events time the device's work and not the host's."""
    import torch

    from repro_torch.serving import server as server_mod

    orig = server_mod.fused_trie_walk
    cycles = int(_sleep_cycles_per_ms() * 5.0)
    pairs = []

    def timed(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        out = orig(*args, **kw)
        stop.record()
        pairs.append((start, stop))
        return out

    server_mod.fused_trie_walk = timed
    try:
        _serve(bank, trie, queries, "trie_fused", emax=EMAX)
    finally:
        server_mod.fused_trie_walk = orig
    torch.cuda.synchronize()
    ms = [a.elapsed_time(b) for a, b in pairs]
    log(f"[serving trie_fused] device time from start to end of the "
        f"fused walk: {sum(ms):.5f} ms over {len(ms)} walks ("
        + ", ".join(f"{m:.5f}" for m in ms) + " ms)")


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
    setup["rows"] = rows["flat"]
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

    # the wall of one pass moves by up to half between runs: SERVE_REPS
    # more cold passes, the layouts taken in turn, after the counted one
    reps = {layout: [walls[layout]] for layout in LAYOUTS}
    for _ in range(SERVE_REPS):
        for layout in LAYOUTS:
            got, _, wall = _serve(bank, trie, queries, layout, emax=EMAX)
            if not np.array_equal(got, rows["flat"]):
                raise AssertionError(f"{layout} rows changed on a repeat")
            reps[layout].append(wall)
    for layout in LAYOUTS:
        w = sorted(reps[layout])
        walls[layout] = w[len(w) // 2]
        log(f"[serving] {layout}: wall of {len(w)} cold passes, median "
            f"{walls[layout]:.4f}s, min {w[0]:.4f}s, max {w[-1]:.4f}s")

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
    _log_fused_walk_device(bank, trie, queries)
    from torch.profiler import ProfilerActivity, profile

    for layout in LAYOUTS:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _serve(bank, trie, queries, layout, emax=EMAX)
            torch.cuda.synchronize()
        _log_device_times(f"[profile serving {layout}]", prof,
                          time.perf_counter() - t0, walls[layout], top_n=8)
    return launches


def _table3_db():
    """The paper's Table 3 default DB (seed 0) and phase 3's sigma and
    max_len."""
    from repro_torch.data.synthetic import Table3Params, generate_table3_db

    params = Table3Params(db_size=1000, v_avg=6, n_interstates=5)
    return generate_table3_db(params, seed=0), 100, 6


def _zero_counts() -> None:
    """Every kernel's launch count and the serving path's call counts
    set to 0."""
    from repro_torch.kernels.containment import ops as cops
    from repro_torch.kernels.match_count import ops as mops
    from repro_torch.kernels.trie_walk import ops as wops
    from repro_torch.serving import batch

    cops.launches = mops.launches = wops.launches = 0
    batch.predicate_calls = batch.fused_walks = 0


def _counts() -> dict:
    """(kernel launches, device calls) of each kernel since the last
    ``_zero_counts``; match_count's calls are filled in by the caller."""
    from repro_torch.kernels.containment import ops as cops
    from repro_torch.kernels.match_count import ops as mops
    from repro_torch.kernels.trie_walk import ops as wops
    from repro_torch.serving import batch

    return {"match_count": [mops.launches, None],
            "contain_step": [cops.launches, batch.predicate_calls],
            "trie_walk": [wops.launches, batch.fused_walks]}


def _check_counts(what, counts, used) -> None:
    """Each kernel launched once per device call, and at least once
    where ``used`` names it."""
    for name, (launches, calls) in counts.items():
        if launches != calls or (name in used and not launches):
            raise AssertionError(
                f"{what}: {name} launched {launches} times for {calls} "
                f"device calls")
    log(f"{what}: launches == device calls: " + ", ".join(
        f"{k} {v[0]}" for k, v in counts.items()))


def _mining_calls(metrics) -> int:
    """match_count's device calls that a registry has counted."""
    return metrics.snapshot().get("mining.n_device_calls", 0)


def _uses(layout):
    return {"flat": ("contain_step",), "trie": ("contain_step",),
            "trie_fused": ("trie_walk",)}[layout]


def _spread(queries, n_hosts):
    reqs = {h: [] for h in range(n_hosts)}
    for i, s in enumerate(queries):
        reqs[i % n_hosts].append(s)
    return reqs


def _unspread(results, n_hosts, n):
    return [results[i % n_hosts][i // n_hosts] for i in range(n)]


def phase_streaming(setup) -> dict:
    """The streaming window on the card: phase 3's DB seeds a
    ``StreamingBank`` (window = the DB), the 1000 queries stream in as
    arrivals, and every refresh - incremental, auto-compacting, and the
    closing full one - is held to a batch re-mine of the window; the
    three layouts end on one map, which equals the host oracle.  The
    launch counts are zeroed after the seed and read after the stream;
    the checks' re-mines are counted apart."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.reverse_search import mine_gtrace_rs
    from repro_torch.kernels.match_count import ops as mops
    from repro_torch.mining.driver import AcceleratedMiner
    from repro_torch.serving.streaming import StreamingBank

    db, sigma, max_len = _table3_db()
    queries = setup["queries"]
    batches = [queries[i:i + STREAM_BATCH]
               for i in range(0, len(queries), STREAM_BATCH)]
    finals, launches, record = {}, {}, None
    for layout in LAYOUTS:
        t0 = time.perf_counter()
        sb = StreamingBank.from_db(
            db, minsup=sigma, window=len(db), max_len=max_len,
            bank_layout=layout, refresh_every=REFRESH_EVERY,
            compact_threshold=COMPACT, device="cuda", emax=EMAX,
            max_batch=MAX_BATCH)
        seed_s = time.perf_counter() - t0
        if sb.bank.n_patterns != setup["bank"].n_patterns:
            raise AssertionError(f"seeded {sb.bank.n_patterns} rFTSs, "
                                 f"expected {setup['bank'].n_patterns}")
        check_launches = 0

        def held(what):
            nonlocal check_launches
            before = mops.launches
            want = AcceleratedMiner(sb.window_seqs, device="cuda").mine_rs(
                sigma, max_len=max_len).patterns
            check_launches += mops.launches - before
            got = sb.frequent()
            if got != want:
                raise AssertionError(
                    f"streaming {layout} {what}: {len(got)} frequent, a "
                    f"batch re-mine of the window {len(want)}; the maps "
                    f"differ")
            return got

        refreshes = []
        _zero_counts()
        t0 = time.perf_counter()
        for i, b in enumerate(batches):
            if sb.observe(b).refreshed:
                refreshes.append((i, held(f"refresh after batch {i}")))
        stream_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            final = sb.refresh(full=True)
            torch.cuda.synchronize()
        full_s = time.perf_counter() - t0
        refreshes.append((len(batches), held("final full refresh")))
        counts = _counts()
        counts["match_count"][0] -= check_launches
        counts["match_count"][1] = _mining_calls(sb.metrics)
        _check_counts(f"[streaming {layout}]", counts,
                      ("match_count",) + _uses(layout))
        launches[layout] = {k: v[0] for k, v in counts.items()}
        st = dict(sb.stats)
        h_obs = sb.metrics.bucket_histogram("streaming.bank.observe_seconds")
        h_ref = sb.metrics.bucket_histogram("streaming.bank.refresh_seconds")
        log(f"[streaming {layout}] seeded {sb.window}-sequence window in "
            f"{seed_s:.3f}s; {len(queries)} arrivals in {len(batches)} "
            f"batches of {STREAM_BATCH} in {stream_s:.3f}s "
            f"({len(queries) / stream_s:.1f} arrivals/s); refreshes after "
            f"batches {[i for i, _ in refreshes[:-1]]}, each == batch "
            f"re-mine; observe_seconds p50 {h_obs.quantile(0.5):.6g} p99 "
            f"{h_obs.quantile(0.99):.6g} (n {h_obs.count}); "
            f"refresh_seconds p50 {h_ref.quantile(0.5):.6g} p99 "
            f"{h_ref.quantile(0.99):.6g} (n {h_ref.count}); incremental "
            f"refreshes {st['refreshes']}, full {st['full_refreshes']} "
            f"(auto compactions {st['auto_compactions']}), tombstoned "
            f"{st['tombstoned']}, recovered {st['recovered']}, added "
            f"{st['added']}, frontier scans {st['frontier_scans']}, "
            f"skipped {st['frontier_scans_skipped']}; {len(final)} "
            f"frequent at the end")
        _log_device_times(f"[profile streaming {layout} full refresh]",
                          prof, full_s, full_s)
        finals[layout] = final
        if layout == "flat":
            record = refreshes
    for layout in LAYOUTS[1:]:
        if finals[layout] != finals["flat"]:
            raise AssertionError(f"streaming {layout} ended on another map "
                                 f"than flat")
    t0 = time.perf_counter()
    oracle = mine_gtrace_rs(sb.window_seqs, sigma,
                            max_len=max_len).patterns
    if finals["flat"] != oracle:
        raise AssertionError(f"streaming ended on {len(finals['flat'])} "
                             f"rFTSs, the host oracle finds {len(oracle)}")
    log(f"[streaming] flat, trie, trie_fused end on one map of "
        f"{len(oracle)} rFTSs == host oracle over the final window "
        f"({time.perf_counter() - t0:.2f}s)")
    return {"record": record, "batches": batches, "launches": launches}


def phase_cluster(setup, stream) -> dict:
    """The simulated cluster on the card: 4 hosts on the one card serve
    the bank (sync ``route`` and async submit/collect) under the three
    layouts, equal to the single-host rows; a seeded fault schedule with
    one host dark answers every query soundly; the sharded window
    replays phase 8's stream and ends each refresh on its map; two read
    replicas serve through a writer refresh, converge, and a crashed one
    replays the recovery log."""
    import numpy as np
    import torch

    from repro_torch.serving.cluster import (ReplicaGroup, ServingCluster,
                                             ShardedStreamingBank)
    from repro_torch.serving.faults import FaultInjector, RetryPolicy
    from repro_torch.serving.streaming import StreamingBank

    bank, queries, want = setup["bank"], setup["queries"], setup["rows"]
    n, H = len(queries), N_HOSTS
    launches = {}
    for layout in LAYOUTS:
        _zero_counts()
        cl = ServingCluster(bank, H, bank_layout=layout, device="cuda",
                            emax=EMAX, max_batch=MAX_BATCH)
        t0 = time.perf_counter()
        got = _unspread(cl.query_multi(_spread(queries, H)), H, n)
        torch.cuda.synchronize()
        sync_s = time.perf_counter() - t0
        ac = ServingCluster(bank, H, bank_layout=layout, device="cuda",
                            emax=EMAX, max_batch=MAX_BATCH,
                            flush_batch=100)
        t0 = time.perf_counter()
        chunks = [queries[i:i + 250] for i in range(0, n, 250)]
        tickets = [ac.submit(_spread(c, H)) for c in chunks]
        agot = [r for c, t in zip(chunks, tickets)
                for r in _unspread(ac.collect(t), H, len(c))]
        torch.cuda.synchronize()
        async_s = time.perf_counter() - t0
        for what, res in (("route", got), ("submit/collect", agot)):
            rows = np.stack([r.contained for r in res])
            if not (all(r.exact for r in res)
                    and np.array_equal(rows, want)):
                raise AssertionError(
                    f"cluster {layout} {what}: rows differ from the "
                    f"single-host server in {int((rows != want).sum())} "
                    f"cells")
        counts = _counts()
        counts["match_count"][1] = 0
        _check_counts(f"[cluster {layout}]", counts, _uses(layout))
        launches[layout] = {k: v[0] for k, v in counts.items()}
        log(f"[cluster {layout}] {H} hosts on one card, shards "
            f"{[len(h.rows) for h in cl.hosts]}: route {n} queries in "
            f"{sync_s:.3f}s ({n / sync_s:.1f} qps), submit/collect in "
            f"{async_s:.3f}s ({n / async_s:.1f} qps), rows == single "
            f"host; router {dict(ac.router.stats)}")

    # host 1 dark from 2 s to 5 s on the fake clock (the drains move it
    # 0.6 s each), transient errors and delays throughout
    now = [0.0]
    inj = FaultInjector(0, error_rate=0.05, delay_rate=0.1, delay=0.01,
                        blackouts=[(1, 2.0, 5.0)], clock=lambda: now[0])
    cl = ServingCluster(
        bank, H, device="cuda", emax=EMAX, max_batch=MAX_BATCH,
        injector=inj, clock=lambda: now[0], max_wait=0.5, flush_batch=64,
        fault_policy=RetryPolicy(retries=2, backoff_base=0.001,
                                 breaker_threshold=3, breaker_cooldown=1.5))
    _zero_counts()
    n_exact = n_flagged = 0
    for i in range(0, n, 100):
        chunk = queries[i:i + 100]
        ticket = cl.submit(_spread(chunk, H))
        now[0] += 0.6
        cl.poll()
        res = _unspread(cl.collect(ticket, timeout=1.0), H, len(chunk))
        for j, r in enumerate(res):
            truth = want[i + j]
            if r.exact:
                if not np.array_equal(r.contained, truth):
                    raise AssertionError(f"chaos: query {i + j} exact but "
                                         f"wrong")
                n_exact += 1
            else:
                if (truth & ~r.contained).any():
                    raise AssertionError(f"chaos: query {i + j} flagged "
                                         f"but not a superset")
                n_flagged += 1
    if n_exact + n_flagged != n or cl.router._tickets:
        raise AssertionError(f"chaos: {n_exact + n_flagged} answers for "
                             f"{n} queries")
    if not (n_exact and n_flagged):
        raise AssertionError(f"chaos: {n_exact} exact and {n_flagged} "
                             f"flagged answers; the schedule missed a path")
    counts = _counts()
    counts["match_count"][1] = 0
    _check_counts("[cluster chaos]", counts, _uses("flat"))
    log(f"[cluster chaos] host 1 dark from 2 s to 5 s, 5 % transient "
        f"errors, 10 % delays: "
        f"{n} queries, {n_exact} exact == single host, {n_flagged} flagged "
        f"supersets, none lost; faults {dict(cl.router.faults)}")

    # the sharded window replays phase 8's stream, refreshing where the
    # flat StreamingBank did
    db, sigma, max_len = _table3_db()
    t0 = time.perf_counter()
    sh = ShardedStreamingBank.from_db(
        db, minsup=sigma, n_hosts=H, window=len(db), max_len=max_len,
        device="cuda", emax=EMAX, max_batch=MAX_BATCH)
    points = dict(stream["record"])
    _zero_counts()
    calls0 = _mining_calls(sh.metrics)
    for i, b in enumerate(stream["batches"]):
        sh.observe(b)
        if i in points and sh.refresh() != points[i]:
            raise AssertionError(f"sharded window: the refresh after batch "
                                 f"{i} differs from the StreamingBank's")
    if sh.refresh(full=True) != points[len(stream["batches"])]:
        raise AssertionError("sharded window: the final full refresh "
                             "differs from the StreamingBank's")
    counts = _counts()
    counts["match_count"][1] = _mining_calls(sh.metrics) - calls0
    _check_counts("[cluster sharded window]", counts,
                  ("match_count",) + _uses(sh.bank_layout))
    log(f"[cluster sharded window] {H} ring slices of "
        f"{len(db) // H}: {len(points)} refreshes, each on the "
        f"StreamingBank's map; {time.perf_counter() - t0:.3f}s; stats "
        f"{dict(sh.stats)}")

    # a writer and two read replicas
    writer = StreamingBank.from_db(
        db, minsup=sigma, window=len(db), max_len=max_len,
        bank_layout="trie_fused", device="cuda", emax=EMAX,
        max_batch=MAX_BATCH)
    group = ReplicaGroup(writer, 2)
    sample = queries[:N_ORACLE]

    def rows_of(rid):
        return np.stack([r.contained for r in
                         group.query(sample, replica=rid)])

    _zero_counts()
    calls0 = _mining_calls(writer.metrics)
    before = rows_of(0)
    writer.observe(stream["batches"][0])
    group.crash(1)
    for b in stream["batches"][1:REFRESH_EVERY]:
        writer.observe(b)
    writer.refresh()
    lag = group.lag(0)
    if not (lag > 0 and np.array_equal(rows_of(0), before)):
        raise AssertionError("replica 0 did not serve its old bank "
                             "through the writer's refresh")
    group.sync(0)
    truth = writer.server.exact_rows(sample)
    replayed = group.restart(1)
    for rid in (0, 1):
        if not np.array_equal(rows_of(rid), truth):
            raise AssertionError(f"replica {rid} rows differ from the "
                                 f"writer's")
    if replayed <= 0:
        raise AssertionError("replica 1 caught up without a replay")
    counts = _counts()
    counts["match_count"][1] = _mining_calls(writer.metrics) - calls0
    _check_counts("[cluster replicas]", counts,
                  ("match_count",) + _uses(writer.bank_layout))
    log(f"[cluster replicas] 2 replicas: replica 0 served its old bank "
        f"through the writer's refresh ({lag} deltas behind), then "
        f"converged; replica 1 crashed, replayed {replayed} deltas of the "
        f"recovery log, verified, rows == writer on {len(sample)} queries")
    return launches


def _dist_scans(db, sigma, max_len):
    """The scans of the multi-rank mining phase, as CPU tensors: the root
    scan (one embedding per sequence) and every pattern scan of a
    recorded Table 3 mine on the card (each chunk split by pid, a
    pattern's rows of every chunk of its wave together), each regrouped
    by DB shard (``gid // (G / DIST_DB)``) into ``DIST_DB`` equal blocks
    padded with ``valid = 0`` rows, gids made shard-local."""
    import numpy as np
    import torch

    from repro_torch.mining import driver
    from repro_torch.mining.driver import AcceleratedMiner
    from repro_torch.mining.encoding import PAD_PHI, PAD_PSI, \
        encode_embeddings, encode_pattern_trs
    from repro_torch.mining.engine import MODE_ROOT

    g_loc = len(db) // DIST_DB
    orig = driver.match_signatures_batch
    rows, tables, wave = {}, {}, [None, -1]

    def record(tokens, gid, phi, psi, valid, pid, ex, nv, npat, mode):
        if ex is not wave[0]:  # a new wave: new pattern tables
            wave[:] = [ex, wave[1] + 1]
        got = [x.cpu().numpy() for x in (gid, phi, psi, valid, pid)]
        for p in np.unique(got[4][got[3] > 0]):
            key = (wave[1], int(p))
            sel = (got[4] == p) & (got[3] > 0)
            rows.setdefault(key, []).append([x[sel] for x in got[:3]])
            tables[key] = (ex[p].cpu(), int(nv[p]), int(npat[p]),
                           int(mode[p]))
        return orig(tokens, gid, phi, psi, valid, pid, ex, nv, npat, mode)

    driver.match_signatures_batch = record
    try:
        AcceleratedMiner(db, device="cuda").mine_rs(sigma, max_len=max_len)
    finally:
        driver.match_signatures_batch = orig

    def scan(gid, phi, psi, existing, nv, n_pat, mode):
        shard = gid // g_loc
        per = int(np.bincount(shard, minlength=DIST_DB).max())
        E = DIST_DB * per
        out = {"gid": np.zeros(E, np.int32),
               "phi": np.full((E, phi.shape[1]), PAD_PHI, np.int32),
               "psi": np.full((E, psi.shape[1]), PAD_PSI, np.int32),
               "valid": np.zeros(E, np.int32)}
        for s in range(DIST_DB):
            sel = np.nonzero(shard == s)[0]
            at = slice(s * per, s * per + len(sel))
            out["gid"][at] = gid[sel] % g_loc
            out["phi"][at], out["psi"][at] = phi[sel], psi[sel]
            out["valid"][at] = 1
        # the global gids, for the single-device reference
        out["ggid"] = (out["gid"] + np.arange(E) // per * g_loc).astype(
            np.int32)
        res = {k: torch.from_numpy(v) for k, v in out.items()}
        res.update(existing=torch.as_tensor(existing), nv=nv, n_pat=n_pat,
                   mode=mode)
        return res

    gid, phi, psi = encode_embeddings([(g, (), ()) for g in range(len(db))],
                                      NI, NV)
    scans = [scan(gid, phi, psi, encode_pattern_trs((), P), 0, 0,
                  MODE_ROOT)]
    for key in sorted(rows):
        parts = rows[key]
        ex, nv, npat, mode = tables[key]
        if npat == 0:  # the miner's own root scan
            continue
        scans.append(scan(*[np.concatenate([p[i] for p in parts])
                            for i in range(3)], ex.numpy(), nv, npat, mode))
    return scans


def _dist_inputs(res, setup) -> dict:
    """Everything the ranks of phase 10 read, with the single-rank
    references they are held to, computed here on the card and checked
    against the host's finalize and oracle first."""
    import numpy as np
    import torch

    from repro_torch.core.containment import contains
    from repro_torch.kernels.containment import ref as cref
    from repro_torch.mining.encoding import encode_db
    from repro_torch.mining.engine import aggregate_host, \
        candidate_table_device, match_signatures_ref
    from repro_torch.serving import batch
    from repro_torch.serving.bank import compile_bank
    from repro_torch.serving.batch import batch_contains, max_key_bucket, \
        trie_contains
    from repro_torch.serving.sharded import stack_trie_shards

    t0 = time.perf_counter()
    db, sigma, max_len = _table3_db()
    tokens = torch.from_numpy(encode_db(db, pad_to=DIST_PAD_T).tokens)
    scans = _dist_scans(db, sigma, max_len)
    tok_c = tokens.cuda()
    for sc in scans:
        args = [sc[k].cuda() for k in ("ggid", "phi", "psi", "valid",
                                       "existing")]
        # a (row, token) signature does not depend on how the DB is
        # split, so the plain scan of the whole DB is every block's
        sigs = match_signatures_ref(tok_c, *args, sc["nv"], sc["n_pat"],
                                    sc["mode"])
        uniq, counts = candidate_table_device(sigs, args[0], DIST_K)
        host = {s: len(g) for s, (g, _) in aggregate_host(
            sigs.cpu().numpy(), sc["ggid"].numpy()).items()}
        table = {int(s): int(c) for s, c in zip(uniq.tolist(),
                                                counts.tolist()) if s >= 0}
        if len(host) >= DIST_K or table != host:
            raise AssertionError(
                f"candidate_table_device differs from aggregate_host on a "
                f"scan ({len(table)} vs {len(host)} signatures)")
        sc["uniq"], sc["counts"] = uniq.cpu(), counts.cpu()
    n_rows = sum(int(sc["valid"].sum()) for sc in scans)
    log(f"[multi-rank] {len(scans)} scans of the Table 3 mine (the root "
        f"and {len(scans) - 1} patterns; {n_rows} embeddings, T "
        f"{tokens.shape[1]}), each scanned by match_count's plain version "
        f"on cuda: candidate_table_device == aggregate_host on each, at "
        f"most {max(int((sc['uniq'] >= 0).sum()) for sc in scans)}"
        f" signatures (k = {DIST_K})")

    bank, trie, queries = setup["bank"], setup["trie"], setup["queries"]
    n_pat = bank.n_patterns
    flat = compile_bank(res, pad_patterns_to=n_pat + n_pat % 2)
    stack = stack_trie_shards(trie.shard(DIST_MODEL))
    q_tok = torch.from_numpy(encode_db(queries).tokens)
    tmax = max_key_bucket(q_tok.numpy(), bank.n_label_keys)
    serve = {"tokens": q_tok, "nv": int(bank.nv),
             "n_label_keys": int(bank.n_label_keys), "tmax": int(tmax),
             "steps": torch.from_numpy(flat.steps),
             "pattern_valid": torch.from_numpy(flat.pattern_valid)}
    for key in ("lvl_steps", "lvl_parent_pos", "term_level", "term_pos"):
        serve[key] = torch.from_numpy(stack[key])
    serve["trie_valid"] = torch.from_numpy(stack["pattern_valid"])
    kw = dict(nv=bank.nv, n_label_keys=bank.n_label_keys, emax=EMAX,
              tmax=tmax)
    c = {k: v.cuda() for k, v in serve.items()
         if isinstance(v, torch.Tensor)}
    # the references join on cuda through contain_step's plain version
    kernel, batch.contain_step = batch.contain_step, cref.contain_step_core
    try:
        ref = {"flat": batch_contains(c["tokens"], c["steps"],
                                      c["pattern_valid"], **kw)}
        S, Pl = DIST_MODEL, stack["rows_per_shard"]
        Mh = stack["lvl_steps"].shape[1] // S
        parts = [trie_contains(
            c["tokens"],
            c["lvl_steps"][:, s * Mh:(s + 1) * Mh].contiguous(),
            c["lvl_parent_pos"][:, s * Mh:(s + 1) * Mh].contiguous(),
            *[c[k][s * Pl:(s + 1) * Pl]
              for k in ("term_level", "term_pos", "trie_valid")], **kw)
            for s in range(S)]
    finally:
        batch.contain_step = kernel
    ref["trie"] = tuple(torch.cat([p[i] for p in parts], 1)
                        for i in (0, 1))
    pats = {"flat": flat.patterns,
            "trie": [p for sh in stack["patterns"] for p in sh]}
    cols = {"flat": np.nonzero(flat.pattern_valid)[0],
            "trie": np.nonzero(stack["pattern_valid"])[0]}
    for layout, (con, ovf) in ref.items():
        con, ovf = con.cpu().numpy(), ovf.cpu().numpy()
        want = np.array([[contains(p, s) for p in pats[layout]]
                         for s in queries[:N_ORACLE]])
        got = con[:N_ORACLE][:, cols[layout]]
        ok = ~ovf[:N_ORACLE][:, cols[layout]]
        if not np.array_equal(got[ok], want[ok]):
            raise AssertionError(f"the single-rank {layout} join differs "
                                 f"from the host oracle")
        serve[f"{layout}_contained"], serve[f"{layout}_overflow"] = \
            torch.from_numpy(con), torch.from_numpy(ovf)
        log(f"[multi-rank] single-rank {layout} join of {len(queries)} "
            f"queries x {con.shape[1]} columns on cuda, contain_step's "
            f"plain version: "
            f"{int(con.sum())} containments, {int(ovf.sum())} overflow "
            f"cells; == host oracle on the first {N_ORACLE} queries where "
            f"no cell overflowed ({int(ok.sum())} cells)")
    log(f"[multi-rank] inputs and references built in "
        f"{time.perf_counter() - t0:.2f}s")
    return {"tokens": tokens, "scans": scans, "serve": serve}


def _dist_job(in_path, scope) -> dict:
    """One rank of phase 10's world (run by ``run_world``): the mining
    step over every scan in both ``prededup`` modes (``scope`` "all") or
    the root scan's step without it, repeated (``scope`` "one"); then
    the flat and the trie serving steps ("all") or the flat one; every
    output held to the single-rank reference, and after the counts were
    read each kernel held to its plain version on this rank's blocks;
    returns a report of counts, walls, errors and mismatches."""
    import torch
    import torch.distributed as dist

    from repro_torch.collectives import rank_device
    from repro_torch.kernels.containment import ops as cops
    from repro_torch.kernels.match_count import ops as mops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.mining.distributed import make_mining_step
    from repro_torch.serving import batch
    from repro_torch.serving.sharded import make_serving_step, \
        make_trie_serving_step

    world = dist.get_world_size()
    mesh = make_host_mesh(model=min(DIST_MODEL, world), device="cuda")
    dev = rank_device(mesh)
    data = torch.load(in_path)
    tokens = data["tokens"].to(dev)
    # "one": the root scan, timed again after the counted step
    scans = data["scans"] if scope == "all" else \
        data["scans"][:1] * (1 + DIST_SERVE_REPS)
    # a 1x1 mesh is one DB shard: it takes the global gids
    gid_key = "gid" if world > 1 else "ggid"
    report = {"rank": dist.get_rank(), "coord": tuple(mesh.get_coordinate()),
              "mining": {}, "serving": {}}
    n_scans = len(scans)
    # one rank holds every pair of a scan, past prededup's k pair slots
    # (a cut, as in the JAX package): the 1x1 mesh gathers the signature
    # matrix
    for prededup in ((False, True) if scope == "all" else (False,)):
        step = make_mining_step(mesh, k=DIST_K, prededup=prededup)
        mops.launches = 0
        walls, bad, nd_max = [], 0, 0
        for i, sc in enumerate(scans):
            if i == n_scans:
                break
            args = [sc[k].to(dev) for k in (gid_key, "phi", "psi", "valid",
                                            "existing")]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            uniq, counts, nd = step(tokens, *args, sc["nv"], sc["n_pat"],
                                    sc["mode"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            bad += int(not (torch.equal(uniq.cpu(), sc["uniq"]) and
                            torch.equal(counts.cpu(), sc["counts"])))
            nd_max = max(nd_max, int(nd))
            if not prededup and i == DIST_PROBE - 1 and n_scans > DIST_CUT:
                # the time budget, decided alike on every rank
                est = torch.tensor(sum(walls) / len(walls) * 2 * n_scans,
                                   device=dev)
                dist.all_reduce(est, op=dist.ReduceOp.MAX)
                if float(est) > DIST_BUDGET_S:
                    n_scans = DIST_CUT
        report["mining"]["prededup" if prededup else "full"] = {
            "scans": len(walls), "of": len(scans), "walls": walls,
            "mismatches": bad, "n_distinct_max": nd_max,
            "launches": mops.launches}
    # after the counts were read
    report.update(_local_checks(mesh, tokens, scans[:n_scans], gid_key))
    serve = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
             for k, v in data["serve"].items()}
    kw = dict(nv=serve["nv"], n_label_keys=serve["n_label_keys"],
              emax=EMAX, tmax=serve["tmax"])
    layouts = {"flat": (make_serving_step, ("tokens", "steps",
                                             "pattern_valid")),
               "trie": (make_trie_serving_step, (
                   "tokens", "lvl_steps", "lvl_parent_pos", "term_level",
                   "term_pos", "trie_valid"))}
    for layout in (("flat", "trie") if scope == "all" else ("flat",)):
        make, names = layouts[layout]
        step = make(mesh, **kw)
        cops.launches = batch.predicate_calls = 0
        walls, bad = [], 0
        for _ in range(1 + DIST_SERVE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            con, ovf = step(*[serve[n] for n in names])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            bad += int(not (torch.equal(con, serve[f"{layout}_contained"])
                            and torch.equal(ovf,
                                            serve[f"{layout}_overflow"])))
        report["serving"][layout] = {
            "steps": len(walls), "walls": walls, "mismatches": bad,
            "launches": cops.launches,
            "predicate_calls": batch.predicate_calls}
        # after the counts were read
        report["serving"][layout].update(
            _checked_step(step, [serve[n] for n in names]))
    return report


def _local_checks(mesh, tokens, scans, gid_key) -> dict:
    """This rank's block of every scan its mining step ran, as the step
    cuts it: match_count's largest error against its plain version on
    the block, and, for the first ``DIST_PROBE`` scans, the wall of the
    step's work on this rank alone (its block's scan and table, no
    collective: the step's wall less this is its collectives and
    waits)."""
    import torch

    from repro_torch.collectives import axes_index, shard_block
    from repro_torch.mining.distributed import _local_candidate_table
    from repro_torch.mining.engine import match_signatures, \
        match_signatures_ref

    shard, n_db = axes_index(mesh, ("data",))
    tok_i, n_tok = axes_index(mesh, ("model",))
    G, T = tokens.shape[:2]
    tok = tokens[shard_block(G, n_db, shard, "sequences"),
                 shard_block(T, n_tok, tok_i, "tokens")].contiguous()
    walls, err, shapes = [], 0, set()
    for i, sc in enumerate(scans):
        rows = shard_block(sc[gid_key].shape[0], n_db, shard, "rows")
        args = [sc[k][rows].to(tokens.device) for k in (
            gid_key, "phi", "psi", "valid")]
        args.append(sc["existing"].to(tokens.device))
        scalars = (sc["nv"], sc["n_pat"], sc["mode"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sigs = match_signatures(tok, *args, *scalars)
        _local_candidate_table(sigs, args[0] + shard * tok.shape[0], DIST_K)
        torch.cuda.synchronize()
        if i < DIST_PROBE:
            walls.append(time.perf_counter() - t0)
        err = max(err, _abs_err(sigs, match_signatures_ref(tok, *args,
                                                           *scalars)))
        shapes.add(tuple(sigs.shape))
    return {"local_walls": walls, "match_count_err": err,
            "match_count_shapes": sorted(shapes)}


def _checked_step(step, args) -> dict:
    """One more serving step whose every contain_step call is held to
    the plain version on the same inputs: the largest error and the
    (G, Ein, Tm) of the calls."""
    from repro_torch.kernels.containment import ref as cref
    from repro_torch.serving import batch

    kernel, errs, shapes = batch.contain_step, [], set()

    def both(tok, psi, srow):
        got = kernel(tok, psi, srow)
        errs.append(_abs_err(got, cref.contain_step_core(tok, psi, srow)))
        shapes.add(tuple(got.shape))
        return got

    batch.contain_step = both
    try:
        step(*args)
    finally:
        batch.contain_step = kernel
    return {"contain_step_err": max(errs), "contain_step_calls": len(errs),
            "contain_step_shapes": sorted(shapes)}


def _run_world(world, backend, in_path, tag, scope):
    """Run ``_dist_job`` on ``world`` spawned ranks of ``backend`` and
    return their reports, in rank order (``tests/torch_dist_worker.py``
    spawns them, raises with a failed rank's traceback and stops every
    rank past ``DIST_TIMEOUT_S``)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_dist_worker import run_world

    work = os.path.join(ROOT, "build", "multi_rank", tag)
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    reports = run_world(_dist_job, world, work, in_path, scope,
                        backend=backend, timeout=DIST_TIMEOUT_S)
    log(f"[multi-rank] {tag}: {world} rank(s) ({backend}) on cuda:0 done "
        f"in {time.perf_counter() - t0:.2f}s")
    return reports


def _check_world(tag, reports) -> dict:
    """Every rank's outputs equal the references, its launches its own
    device calls, each kernel its plain version on the rank's blocks;
    the per-rank counts and errors and rank 0's walls printed.  Returns
    each kernel's largest error."""
    for rep in reports:
        for mode, m in rep["mining"].items():
            if m["mismatches"] or m["n_distinct_max"] > DIST_K or \
                    m["launches"] != m["scans"] or not m["scans"]:
                raise AssertionError(f"{tag} rank {rep['rank']} mining "
                                     f"({mode}): {m}")
        for layout, s in rep["serving"].items():
            if s["mismatches"] or not s["predicate_calls"] or \
                    s["launches"] != s["predicate_calls"] or \
                    s["contain_step_calls"] * s["steps"] != \
                    s["predicate_calls"]:
                raise AssertionError(f"{tag} rank {rep['rank']} serving "
                                     f"({layout}): {s}")
    errs = {"match_count": max(r["match_count_err"] for r in reports),
            "contain_step": max(s["contain_step_err"] for r in reports
                                for s in r["serving"].values())}
    log(f"[multi-rank] {tag} per-rank launches == device calls: " + "; ".join(
        f"rank {r['rank']} {r['coord']}: " + ", ".join(
            [f"match_count {m['launches']}/{m['scans']} steps ({mode})"
             for mode, m in r['mining'].items()] +
            [f"contain_step {s['launches']}/{s['predicate_calls']} "
             f"predicate calls ({layout})"
             for layout, s in r['serving'].items()])
        for r in reports))
    r0 = reports[0]
    es, ts = (sorted({sh[i] for sh in r0["match_count_shapes"]})
              for i in (0, 1))
    log(f"[multi-rank] {tag} each rank's kernels vs their plain versions on "
        f"its blocks: match_count max_abs_err {errs['match_count']} over "
        f"every scan it stepped (rank 0's [E, T]: {len(es)} E from "
        f"{es[0]} to {es[-1]}, T {', '.join(map(str, ts))}); "
        f"contain_step max_abs_err {errs['contain_step']} over every call "
        f"of one more step a layout (rank 0's [G, Ein, Tm] " + "; ".join(
            f"{layout} " + ", ".join("x".join(map(str, sh))
                                     for sh in s["contain_step_shapes"])
            for layout, s in r0["serving"].items()) + ")")
    if any(errs.values()):
        raise AssertionError(f"{tag}: a kernel differs from its plain "
                             f"version on a rank's block: {errs}")
    for mode, m in r0["mining"].items():
        ms = [1e3 * w for w in m["walls"]]
        if m["scans"] < m["of"]:
            log(f"[multi-rank] {tag} mining ({mode}): cut to the first "
                f"{m['scans']} of {m['of']} scans (the estimate passed "
                f"{DIST_BUDGET_S}s)")
        log(f"[multi-rank] {tag} mining step ({mode}), rank 0: "
            f"{m['scans']} steps == single-device candidate_table_device, "
            f"n_distinct <= {m['n_distinct_max']}; wall per step median "
            f"{statistics.median(ms):.3f} ms, mean "
            f"{statistics.mean(ms):.3f} ms, min {min(ms):.3f}, max "
            f"{max(ms):.3f} (first {ms[0]:.3f})")
    ms = [1e3 * w for r in reports for w in r["local_walls"]]
    log(f"[multi-rank] {tag} the step's work on one rank alone (its "
        f"block's scan and table, no collective), the first "
        f"{len(r0['local_walls'])} scans on every rank: median "
        f"{statistics.median(ms):.3f} ms, min {min(ms):.3f}, max "
        f"{max(ms):.3f}")
    for layout, s in r0["serving"].items():
        ms = [1e3 * w for w in s["walls"]]
        log(f"[multi-rank] {tag} {layout} serving step, rank 0: "
            f"{s['steps']} steps == the single-rank join; wall per step "
            f"{', '.join(f'{x:.3f}' for x in ms)} ms (median of the last "
            f"{DIST_SERVE_REPS} {statistics.median(ms[1:]):.3f} ms)")
    return errs


def phase_multi_rank(res, setup) -> dict:
    """Phase 10: the multi-rank steps on the one card; returns each
    kernel's largest error against its plain version on a rank's
    blocks."""
    import torch

    data = _dist_inputs(res, setup)
    in_path = os.path.join(ROOT, "build", "multi_rank", "inputs.pt")
    os.makedirs(os.path.dirname(in_path), exist_ok=True)
    torch.save(data, in_path)
    errs = [_check_world("gloo 4x2", _run_world(
                DIST_DB * DIST_MODEL, "cpu:gloo,cuda:gloo", in_path, "gloo",
                "all")),
            _check_world("nccl 1x1", _run_world(1, "nccl", in_path, "nccl",
                                                "one"))]
    return {name: max(e[name] for e in errs) for name in errs[0]}


def phase_serve_launcher() -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    for extra in ([], ["--emax", "1"], ["--window", "150"],
                  ["--window", "150", "--replicas", "2"], ["--hosts", "4"],
                  ["--window", "150", "--hosts", "2"]):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cuda", "--bank-layout", "trie_fused", *extra],
            env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
        for line in proc.stdout.splitlines():
            if not line.startswith("[serve] batch "):
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


# phase 11, the LM family: smollm-135m at full width (train_4k's seq at
# batch 8, cut from 256; prefill at seq 32768, batch 1, cut from 32;
# decode at batch 16, cut from 128, on a 32768-slot cache)
LM_ARCH, MOE_ARCH = "smollm-135m", "olmoe-1b-7b"
LM_IDS = ("glm4-9b", "gemma-7b", "smollm-135m",
          "llama4-maverick-400b-a17b", "olmoe-1b-7b")
LM_BATCH, LM_SEQ, LM_STEPS, LM_LOOP_STEPS = 8, 4096, 4, 2
LM_PREFILL_SEQ, LM_DECODE_BATCH, LM_DECODE_TOKENS = 32768, 16, 32
# the checks: bf16 step 1 vs fp32; blockwise vs naive attention at
# [1, 4096, 9, 64] / kv 3 (fp32); decode vs forward over 64 tokens at
# batch 2 (fp32), the JAX decode test's tolerance
LM_STEP1_RTOL, LM_ATTN_TOL, LM_DECODE_CHECK = 2e-2, 2e-5, 64
# olmoe-1b-7b: one MoE layer on 4096 tokens (fp32) against a per-expert
# loop; the whole model's prefill at batch 1, seq 2048 (fp32 params)
MOE_TOKENS, MOE_TOL, MOE_PREFILL_SEQ = 4096, 1e-4, 2048
LM_LAUNCH_STEPS = 100


def _mem_gb() -> str:
    import torch

    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


def _reset_mem() -> None:
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def _lm_batches(seed, vocab, batch, seq, device):
    import torch
    from repro_torch.data.lm import token_batches

    for b in token_batches(seed, vocab, batch, seq):
        yield {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def _tree_max_diff(a, b) -> float:
    from repro_torch.models.common import tree_leaves

    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def _lm_profile(tag, fn, wall) -> None:
    """Device time by kernel of one more call of ``fn`` under the
    profiler, against ``wall``, the unprofiled call's seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    _log_device_times(tag, prof, prof_wall, wall, top_n=8, port=False)


def _lm_attention(gpu: str) -> None:
    """blockwise == naive at smollm's heads, fp32; then the yardstick:
    the blockwise forward at [8, 4096, 9, 64] / kv 3 in bf16 beside
    ``scaled_dot_product_attention`` on the GQA-expanded inputs (printed
    only: the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.attention import blockwise_causal_attention, \
        naive_causal_attention

    g = torch.Generator("cuda").manual_seed(11)
    q = torch.randn(1, 4096, 9, 64, generator=g, device="cuda")
    k = torch.randn(1, 4096, 3, 64, generator=g, device="cuda")
    v = torch.randn(1, 4096, 3, 64, generator=g, device="cuda")
    got = blockwise_causal_attention(q, k, v, block_q=512, block_kv=1024)
    want = naive_causal_attention(q, k, v)
    err = float((got - want).abs().max())
    if not err <= LM_ATTN_TOL:
        raise AssertionError(f"blockwise vs naive attention: {err}")
    log(f"[lm] blockwise == naive attention at [1, 4096, 9, 64] / kv 3, "
        f"fp32: max |diff| {err:.3g} (<= {LM_ATTN_TOL})")

    q = torch.randn(8, 4096, 9, 64, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    k = torch.randn(8, 4096, 3, 64, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn(8, 4096, 3, 64, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    qh, kh, vh = (x.transpose(1, 2) for x in
                  (q, k.repeat_interleave(3, 2), v.repeat_interleave(3, 2)))
    with torch.no_grad():
        ours, _ = _time_ms(lambda: blockwise_causal_attention(
            q, k, v, block_q=512, block_kv=1024), reps=3, rounds=3)
        lib, _ = _time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True), reps=10, rounds=3)
    log(f"[lm] attention yardstick [8, 4096, 9, 64] / kv 3, bf16 in: "
        f"blockwise forward {ours:.3f} ms, scaled_dot_product_attention "
        f"(is_causal, GQA expanded) {lib:.3f} ms ({gpu})")


def _lm_smollm(gpu: str) -> None:
    """smollm-135m at full width: the arch's train step, the train loop
    with grad_accum 2 and a checkpoint, prefill at 32768, decode on a
    32768-slot cache, and the checks on the card."""
    import dataclasses

    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import count_params, value_and_grad
    from repro_torch.models.common import tree_leaves
    from repro_torch.training import checkpoint, train_loop
    from repro_torch.training.optimizer import global_norm

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_checks import decode_vs_forward

    arch = get_arch(LM_ARCH)
    cfg = arch.cfg
    dev = torch.device("cuda")
    _reset_mem()
    params = arch.init_params(torch.Generator("cuda").manual_seed(0),
                              "train_4k", dev)
    n_params = count_params(params)
    log(f"[lm] {LM_ARCH}: {n_params} params, {cfg.n_layers} L, d "
        f"{cfg.d_model}, {cfg.n_heads} H / kv {cfg.n_kv_heads}, vocab "
        f"{cfg.vocab}, {cfg.param_dtype} params, {cfg.compute_dtype} "
        f"compute, remat {cfg.remat}")
    batches = _lm_batches(0, cfg.vocab, LM_BATCH, LM_SEQ, dev)
    first = next(batches)

    # step 1 at bf16 vs fp32 compute: loss and gradient global norm
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    got = {}
    for name, c in (("bf16", cfg), ("fp32", cfg32)):
        loss, grads = value_and_grad(
            lambda p, b, c=c: tf.lm_loss(p, b, c))(params, first)
        got[name] = (float(loss), float(global_norm(grads)))
        del grads
    for i, what in enumerate(("loss", "grad norm")):
        rel = abs(got["bf16"][i] - got["fp32"][i]) / abs(got["fp32"][i])
        if not rel <= LM_STEP1_RTOL:
            raise AssertionError(f"step 1 {what} bf16 {got['bf16'][i]} vs "
                                 f"fp32 {got['fp32'][i]}: rel {rel:.3g}")
        log(f"[lm] step 1 {what}: bf16 {got['bf16'][i]:.6f}, fp32 "
            f"{got['fp32'][i]:.6f}, rel {rel:.3g} (<= {LM_STEP1_RTOL})")
    log(f"[lm] step-1 checks peak {_mem_gb()}")

    step, (abstract, _, abatch) = arch.make_step("train_4k")
    opt = arch.optimizer()
    _reset_mem()
    p, state = params, opt.init(params)
    losses, times = [], []
    batch = first
    for i in range(LM_STEPS):
        t0 = time.perf_counter()
        loss, p, state = step(p, state, batch)
        losses.append(float(loss))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        batch = next(batches)
    moved = _tree_max_diff(params, p)
    if not all(map(math.isfinite, losses)) or moved <= 0:
        raise AssertionError(f"train losses {losses}, params moved {moved}")
    ms = 1e3 * statistics.median(times[1:])
    log(f"[lm] train_4k step (batch {LM_BATCH}, cut from "
        f"{tuple(abatch['tokens'].shape)[0]}; seq {LM_SEQ}): losses "
        f"{[round(x, 4) for x in losses]}, params moved {moved:.3g}; "
        f"first {1e3 * times[0]:.1f} ms, then median {ms:.1f} ms = "
        f"{LM_BATCH * LM_SEQ / ms * 1e3:.0f} tokens/s; peak {_mem_gb()} "
        f"({gpu})")
    _lm_profile("[lm] train step profiled:", lambda: step(p, state, batch),
                1e-3 * ms)
    del state

    _reset_mem()
    path = os.path.join(ROOT, "build", "lm_ckpt.npz")
    t0 = time.perf_counter()
    lp, lstate, llosses = train_loop.train(
        arch.loss_fn("train_4k"), p, batches, LM_LOOP_STEPS, opt=opt,
        grad_accum=2, checkpoint_path=path, checkpoint_every=1,
        log_every=1, log=lambda m: log(f"  {m}"))
    loop_s = time.perf_counter() - t0
    back, at = checkpoint.restore(path, (lp, lstate))
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves((lp, lstate)), tree_leaves(back)))
    if at != LM_LOOP_STEPS or not same or \
            not all(map(math.isfinite, llosses)):
        raise AssertionError(f"train loop: step {at}, restored equal "
                             f"{same}, losses {llosses}")
    for f in (path, path + ".meta.json"):
        os.unlink(f)
    log(f"[lm] train loop: {LM_LOOP_STEPS} steps, grad_accum 2, async "
        f"checkpoint each step: losses {llosses}, {loop_s:.2f} s with the "
        f"checkpoints; restored bit-equal at step {at}; peak {_mem_gb()}")
    del lp, lstate, back, p

    prefill, _ = arch.make_step("prefill_32k")
    toks = next(_lm_batches(1, cfg.vocab, 1, LM_PREFILL_SEQ, dev))["tokens"]
    _reset_mem()
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = prefill(params, toks)
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.perf_counter() - t0)
    if tuple(logits.shape) != (1, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)}")
    log(f"[lm] prefill (batch 1, cut from 32; seq {LM_PREFILL_SEQ}): "
        f"{pre_ms:.1f} ms, finite [1, 1, {cfg.vocab}] logits; peak "
        f"{_mem_gb()} ({gpu})")

    decode, _ = arch.make_step("decode_32k")
    _reset_mem()
    cache = tf.init_cache(cfg, LM_DECODE_BATCH, LM_PREFILL_SEQ, device=dev)
    tok = toks[0, :LM_DECODE_BATCH].reshape(LM_DECODE_BATCH, 1)
    times = []
    with torch.no_grad():
        for _ in range(LM_DECODE_TOKENS):
            t0 = time.perf_counter()
            logits, cache = decode(params, cache, tok)
            tok = logits.argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    if not bool(torch.isfinite(logits).all()) or \
            cache["len"].tolist() != [LM_DECODE_TOKENS] * LM_DECODE_BATCH:
        raise AssertionError("decode: non-finite logits or cache length")
    log(f"[lm] decode (batch {LM_DECODE_BATCH}, cut from 128; "
        f"{LM_PREFILL_SEQ}-slot bf16 cache): {LM_DECODE_TOKENS} tokens, "
        f"median {1e3 * statistics.median(times[1:]):.2f} ms a token "
        f"(first {1e3 * times[0]:.1f}); peak {_mem_gb()} ({gpu})")
    with torch.no_grad():
        _lm_profile("[lm] decode token profiled:",
                    lambda: decode(params, cache, tok),
                    statistics.median(times[1:]))
    del cache

    _reset_mem()
    toks = next(_lm_batches(2, cfg.vocab, 2, LM_DECODE_CHECK, dev))["tokens"]
    err = decode_vs_forward(params, toks, cfg32)
    log(f"[lm] decode == forward + logits_fn at fp32, batch 2, "
        f"{LM_DECODE_CHECK} tokens: max |diff| {err:.3g} (<= 2e-4)")


def _moe_loop_ref(mp, xf, cfg):
    """A per-expert loop over the same router: the routes to expert e in
    token-major, k-minor order, the first ``cap`` kept; returns (out,
    dropped routes)."""
    import math

    import torch
    import torch.nn.functional as F

    n = xf.shape[0]
    cap = max(1, math.ceil(n * cfg.top_k / cfg.n_experts
                           * cfg.capacity_factor))
    probs = torch.softmax(
        torch.einsum("nd,de->ne", xf.float(), mp["wr"].float()), -1)
    gate, idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    out = torch.zeros_like(xf)
    dropped = 0
    for e in range(cfg.n_experts):
        routes = (idx == e).nonzero()
        dropped += max(0, routes.shape[0] - cap)
        tok, kpos = routes[:cap, 0], routes[:cap, 1]
        x = xf[tok]
        h = F.silu(x @ mp["wg"][e]) * (x @ mp["wi"][e])
        out.index_add_(0, tok, (h @ mp["wo"][e]) * gate[tok, kpos][:, None])
    return out, dropped


def _lm_olmoe(gpu: str) -> None:
    """olmoe-1b-7b at full width: one MoE layer (fp32) against the loop
    reference, then the whole model's prefill."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.common import count_params
    from repro_torch.models.moe import moe_ffn, moe_route

    arch = get_arch(MOE_ARCH)
    cfg, mcfg = arch.cfg, arch.cfg.moe
    d, e, f = cfg.d_model, mcfg.n_experts, mcfg.d_ff
    g = torch.Generator("cuda").manual_seed(5)

    def w(*shape):
        return torch.randn(*shape, generator=g, device="cuda") * d ** -0.5
    mp = {"wr": w(d, e), "wi": w(e, d, f), "wg": w(e, d, f),
          "wo": w(e, f, d)}
    x = torch.randn(1, MOE_TOKENS, d, generator=g, device="cuda")
    _reset_mem()
    with torch.no_grad():
        out, aux = moe_ffn(mp, x, mcfg)
        keep = moe_route(mp, x.reshape(-1, d), mcfg)[3]
        torch.cuda.synchronize()
        ms, _ = _time_ms(lambda: moe_ffn(mp, x, mcfg), reps=5, rounds=3)
        ref, dropped = _moe_loop_ref(mp, x.reshape(-1, d), mcfg)
    err = float((out.reshape(-1, d) - ref).abs().max())
    ours_dropped = int((~keep).sum())
    if not err <= MOE_TOL or ours_dropped != dropped:
        raise AssertionError(f"moe_ffn vs the loop: max |diff| {err}, "
                             f"dropped {ours_dropped} vs {dropped}")
    log(f"[lm] {MOE_ARCH} moe_ffn, {MOE_TOKENS} tokens, {e} experts top-"
        f"{mcfg.top_k}, d {d}, expert d_ff {f}, fp32: == per-expert loop "
        f"within {err:.3g} (<= {MOE_TOL}); {dropped} of "
        f"{MOE_TOKENS * mcfg.top_k} routes dropped by both; aux "
        f"{float(aux):.4f}; {ms:.3f} ms a layer; peak {_mem_gb()} ({gpu})")
    del mp, x, out, ref

    _reset_mem()
    t0 = time.perf_counter()
    params = arch.init_params(torch.Generator("cuda").manual_seed(0),
                              "prefill_32k", torch.device("cuda"))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prefill, _ = arch.make_step("prefill_32k")
    toks = next(_lm_batches(3, cfg.vocab, 1, MOE_PREFILL_SEQ,
                            "cuda"))["tokens"]
    with torch.no_grad():
        t0 = time.perf_counter()
        logits = prefill(params, toks)
        torch.cuda.synchronize()
        pre_ms = 1e3 * (time.perf_counter() - t0)
    if tuple(logits.shape) != (1, 1, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{MOE_ARCH} prefill logits")
    log(f"[lm] {MOE_ARCH} prefill, full depth ({cfg.n_layers} L) and "
        f"width, {count_params(params)} fp32 params (init {init_s:.2f} s), "
        f"batch 1, seq {MOE_PREFILL_SEQ}: {pre_ms:.1f} ms, finite logits; "
        f"peak {_mem_gb()} ({gpu})")
    del params


def _lm_smoke_configs() -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_lm_checks import BF16_RTOL, FP32_TOL, smoke_step_vs_cpu

    for arch_id in LM_IDS:
        e = smoke_step_vs_cpu(arch_id)
        log(f"[lm] smoke {arch_id}: cuda vs cpu, bf16 loss "
            f"{e['loss_cuda']:.6f} / {e['loss_cpu']:.6f} (rel "
            f"{e['bf16_loss_rel']:.3g} <= {BF16_RTOL}); fp32 max |diff| "
            f"loss {e['fp32_loss']:.3g}, grads {e['fp32_grads']:.3g}, "
            f"update on the same grads {e['fp32_update']:.3g} "
            f"(<= {FP32_TOL})")


def _lm_launcher() -> None:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         LM_ARCH, "--steps", str(LM_LAUNCH_STEPS), "--device", "cuda"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    last = proc.stdout.strip().splitlines()[-1] if proc.stdout else ""
    if proc.returncode != 0 or "first-10 mean loss" not in last:
        raise AssertionError(f"launch.train failed ({proc.returncode}):\n"
                             f"{proc.stderr[-4000:]}")
    first, final = (float(w) for w in last.split() if
                    w.replace(".", "", 1).isdigit())
    if not final < first:
        raise AssertionError(f"launch.train did not learn: {last}")
    log(f"  {last}")
    log(f"[launcher] train --arch {LM_ARCH} --steps {LM_LAUNCH_STEPS} on "
        f"cuda in {time.perf_counter() - t0:.2f}s")


def phase_lm() -> None:
    """Phase 11: the LM family on the card (no TPU kernel on this path:
    its products are plain matmuls, as in the JAX package)."""
    import torch

    # fp32 products in full fp32 on the card, for every comparison here
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    gpu = _gpu_line()
    _lm_attention(gpu)
    _lm_smollm(gpu)
    _lm_olmoe(gpu)
    _lm_smoke_configs()
    _lm_launcher()
    log(f"[lm] phase 11 wall {time.perf_counter() - t0:.1f}s ({gpu})")


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
    global PEAK_OPS_PER_S
    PEAK_OPS_PER_S = _int32_peak()
    log(f"[env] int32 peak {PEAK_OPS_PER_S:.6g} ops/s "
        f"({INT32_OPS_PER_SM_CLOCK} a clock per SM x SMs x max SM clock)")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    phase_build()
    kernels = [phase_match_count()]
    launches, res, chunk = phase_main_path()
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    phase_match_count_chunk(chunk))
    phase_launcher()
    setup = serving_setup(res)
    kernels += phase_serving_kernels(setup)
    launches.update(phase_serving(setup))
    phase_serve_launcher()
    stream = phase_streaming(setup)
    phase_cluster(setup, stream)
    dist_errs = phase_multi_rank(res, setup)
    phase_lm()

    for k in kernels:
        k["max_abs_err"] = max(k["max_abs_err"], dist_errs.get(k["name"], 0))
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
