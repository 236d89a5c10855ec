"""Mining launcher: run GTRACE-RS (or the GTRACE baseline) over a
generated or loaded graph-sequence DB with checkpoint/restart.

    python -m repro_torch.launch.mine --algo both --device cuda

``--device cpu`` runs the scans' plain PyTorch version instead of the
CUDA kernel; there is no silent fallback from one to the other."""
from __future__ import annotations

import argparse
import time

from ..data.synthetic import Table3Params, generate_table3_db
from ..mining.driver import AcceleratedMiner


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--db-size", type=int, default=200)
    ap.add_argument("--v-avg", type=int, default=5)
    ap.add_argument("--interstates", type=int, default=4)
    ap.add_argument("--min-support-frac", type=float, default=0.1)
    ap.add_argument("--max-len", type=int, default=6)
    ap.add_argument("--algo", choices=["rs", "gtrace", "both"],
                    default="both")
    ap.add_argument("--dispatch", choices=["wavefront", "pattern"],
                    default="wavefront",
                    help="wavefront = frontier-batched device scans "
                         "(default); pattern = seed one-dispatch-per-"
                         "pattern baseline")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the match_count kernel) or cpu (its plain "
                         "PyTorch version)")
    args = ap.parse_args()

    params = Table3Params(db_size=args.db_size, v_avg=args.v_avg,
                          n_interstates=args.interstates)
    db = generate_table3_db(params, seed=args.seed)
    sigma = max(2, int(args.min_support_frac * len(db)))
    print(f"[mine] |DB|={len(db)} sigma={sigma} max_len={args.max_len} "
          f"device={args.device}")

    miner = AcceleratedMiner(db, dispatch=args.dispatch,
                             device=args.device)
    if args.algo in ("rs", "both"):
        t0 = time.time()
        rs = miner.mine_rs(sigma, max_len=args.max_len,
                           checkpoint_path=args.checkpoint,
                           resume=args.resume)
        print(f"[mine] GTRACE-RS: {len(rs.patterns)} rFTSs "
              f"({rs.n_enumerated} nodes) in {time.time()-t0:.2f}s, "
              f"device {miner.device_seconds:.2f}s "
              f"(launch {miner.dispatch_seconds:.2f}s)/"
              f"{miner.n_device_calls} calls")
    if args.algo in ("gtrace", "both"):
        t0 = time.time()
        gt = miner.mine_gtrace(sigma, max_len=args.max_len)
        rel = gt.relevant()
        print(f"[mine] GTRACE:   {len(gt.patterns)} FTSs -> "
              f"{len(rel)} rFTSs in {time.time()-t0:.2f}s")
    if args.algo == "both":
        if rel != rs.patterns:
            raise SystemExit("[mine] baseline/RS mismatch!")
        print("[mine] GTRACE.relevant() == GTRACE-RS  (verified)")


if __name__ == "__main__":
    main()
