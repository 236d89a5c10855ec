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
5. one JSON line describing every ported kernel, then the last line
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
KERNELS = ("match_count",)


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
        top = sorted(dev.items(), key=lambda kv: -kv[1][0])[:6]
        log(f"[profile] device busy {busy_ms:.4f} ms in the profiled run "
            f"(wall {prof_wall:.3f}s) = {100 * busy_ms / 1e3 / wall:.4f}% "
            f"of the unprofiled wall {wall:.3f}s; by name: "
            + "; ".join(f"{k[:48]} {v / 1e3:.4f} ms / {n} = "
                        f"{v / max(n, 1):.2f} us each"
                        for k, (v, n) in top))
    else:
        log("[profile] the profiler recorded no device time: not measured")
    return launches


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
    launches = phase_main_path()
    phase_launcher()

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
