"""Traffic kind ``mine``: mining jobs back to back on the run's DB, each
``mine(db, sigma, max_len)`` on a fresh miner; every job started inside
the window runs to its end.  The unit is a job.

Mix parameters: ``profile_ops`` (the jobs of a traced run's profiled
slice).  End-to-end: ``mine_s``, the mean wall of the window's jobs.
"""
from __future__ import annotations

import time
from typing import Dict, List

from bench_port.lib import check
from bench_port.lib.data import make_inputs, min_support


class Work:
    def __init__(self, system, cfg: dict, mix: dict, seed: int):
        self.system = system
        self.db_ref, _ = make_inputs(cfg, seed)
        self.db = system.native(self.db_ref)
        self.sigma = min_support(cfg, len(self.db))
        self.max_len = cfg["max_len"]
        self.jobs: List[tuple] = []       # (wall s, device s) per job
        self.outputs: List[dict] = []

    def setup(self) -> None:
        self.system.mine(self.db, self.sigma, self.max_len)

    def op(self) -> int:
        t0 = time.perf_counter()
        out = self.system.mine(self.db, self.sigma, self.max_len)
        self.jobs.append((time.perf_counter() - t0, out.device_seconds))
        self.outputs.append(out.patterns)
        return 1

    def end_to_end(self, window_s: float) -> Dict[str, float]:
        walls = [w for w, _ in self.jobs]
        return {"mine_s": sum(walls) / len(walls)}

    def counters(self) -> Dict[str, float]:
        return dict(self.system.launches(),
                    device_seconds=sum(d or 0.0 for _, d in self.jobs),
                    jobs=len(self.jobs),
                    job_seconds=sum(w for w, _ in self.jobs))

    def checks(self, seed: int) -> List[Dict]:
        want = check.reference_map(self.db_ref, self.sigma, self.max_len)
        return check.check_mining(self.outputs, want)
