"""Serving launcher: mine an rFTS bank, stand up a PatternServer, and
drive a synthetic query workload end to end on one host.

    python -m repro_torch.launch.serve --device cuda --bank-layout trie_fused

On ``cuda`` every join predicate launches the containment kernel and
every fused walk the trie-walk kernel; ``--device cpu`` runs their plain
PyTorch versions instead.  There is no ``--use-kernel``: the device
decides, and there is no silent fallback from one to the other.  The
run ends by holding the first ``--verify`` queries' rows to the host
oracle (``core.containment.contains``).

The streaming window (``--window``), the multi-host cluster
(``--hosts``) and read replicas (``--replicas``) of the JAX package's
launcher are not ported yet: asking for them exits with an error.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..core.containment import contains
from ..core.graphseq import pattern_str
from ..data.synthetic import Table3Params, generate_table3_db
from ..mining.driver import AcceleratedMiner
from ..serving.bank import compile_bank
from ..serving.layouts import get_layout
from ..serving.server import PatternServer
from ..serving.trie import build_trie


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=150)
    ap.add_argument("--v-avg", type=int, default=5)
    ap.add_argument("--interstates", type=int, default=3)
    ap.add_argument("--min-support-frac", type=float, default=0.1)
    ap.add_argument("--max-len", type=int, default=4)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--emax", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=512)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--top-patterns", type=int, default=None,
                    help="serve only the strongest N patterns")
    ap.add_argument("--bank-layout",
                    choices=("flat", "trie", "trie_fused"),
                    default="flat",
                    help="flat per-pattern joins, or the prefix-trie "
                         "layout that joins shared rFTS prefixes once")
    ap.add_argument("--window", type=int, default=None,
                    help="streaming mode (not ported yet)")
    ap.add_argument("--hosts", type=int, default=1,
                    help="multi-host cluster (not ported yet)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="read replicas (not ported yet)")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--verify", type=int, default=16,
                    help="hold this many queries' rows to the host oracle")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the serving kernels) or cpu (their plain "
                         "PyTorch versions)")
    args = ap.parse_args()
    for flag, unset in (("window", None), ("hosts", 1), ("replicas", 0)):
        if getattr(args, flag) != unset:
            ap.error(f"--{flag} is not ported yet: the PyTorch port serves "
                     f"on a single host without a streaming window")

    params = Table3Params(db_size=args.db_size, v_avg=args.v_avg,
                          n_interstates=args.interstates)
    db = generate_table3_db(params, seed=args.seed)
    sigma = max(2, int(args.min_support_frac * len(db)))
    print(f"[serve] mining |DB|={len(db)} sigma={sigma} "
          f"max_len={args.max_len} device={args.device}")
    miner = AcceleratedMiner(db, device=args.device)
    t0 = time.time()
    res = miner.mine_rs(sigma, max_len=args.max_len,
                        checkpoint_path=args.checkpoint,
                        resume=args.resume)
    bank = compile_bank(res, top=args.top_patterns)
    print(f"[serve] bank: {bank.n_patterns} rFTSs "
          f"(max {bank.max_steps} TRs, {bank.nv} vertices) "
          f"mined in {time.time()-t0:.2f}s")
    trie = None
    if get_layout(args.bank_layout).uses_trie:
        trie = build_trie(bank)
        print(f"[serve] trie: {trie.n_nodes} nodes, depth {trie.depth},"
              f" sharing x{trie.sharing_ratio:.2f}")

    srv = PatternServer(bank, emax=args.emax, max_batch=args.max_batch,
                        topk=args.topk, bank_layout=args.bank_layout,
                        trie=trie, device=args.device)
    qparams = Table3Params(db_size=args.queries, v_avg=args.v_avg,
                           n_interstates=args.interstates)
    queries = generate_table3_db(qparams, seed=args.seed + 1)
    srv.query(queries[: min(len(queries), args.max_batch)])  # warm up
    srv._cache.clear()
    t0 = time.time()
    results = srv.query(queries)
    dt = time.time() - t0
    n_hits = sum(len(r.pattern_ids) for r in results)
    print(f"[serve] {len(queries)} queries in {dt:.3f}s "
          f"({len(queries)/max(dt, 1e-9):.0f} qps), "
          f"{n_hits} containments, stats={srv.stats}")
    best = results[0]
    print(f"[serve] sample top-{args.topk} for query 0:")
    for pid, sup in best.topk:
        print(f"    [{sup:3d}] {pattern_str(bank.patterns[pid])}")
    # second pass: everything cache-served
    t0 = time.time()
    srv.query(queries)
    print(f"[serve] cached pass {time.time()-t0:.3f}s, "
          f"cache_hits={srv.stats['cache_hits']}")
    n = min(args.verify, len(queries))
    shape = (n, bank.n_patterns)
    got = np.array([r.contained for r in results[:n]], bool).reshape(shape)
    want = np.array([[contains(p, s) for p in bank.patterns]
                     for s in queries[:n]], bool).reshape(shape)
    if not np.array_equal(got, want):
        raise SystemExit(f"[serve] rows differ from the host oracle in "
                         f"{int((got != want).sum())} cells")
    print(f"[serve] first {n} queries == host oracle  (verified)")


if __name__ == "__main__":
    main()
