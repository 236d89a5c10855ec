"""The system under test behind one small interface, and the control.

``ProgramSystem`` drives the PyTorch port: ``AcceleratedMiner.mine_rs``
on a fresh miner per job, ``compile_bank`` of the whole mined map, and
``PatternServer.query``.  The benchmark takes nothing else from it but its
spans, counters and kernel names.  ``ControlSystem`` puts the reference,
with one exactness guarantee broken (``reference.control``), in the
program's place: the comparison that decides ``correct`` has to fail it.

Both speak the same small interface, which is all ``driver`` and
``check`` use:

* ``native(seqs)``: the sequences in the system's own classes;
* ``mine(db, sigma, max_len)`` -> ``MineOut``;
* ``server(patterns, params)`` -> an object with ``query(seqs)``,
  ``rows()`` (``(pattern, support)`` in bank row order),
  ``answer(a)`` (``(contained row, top-k [(row, support)])``) and
  ``counters()``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Optional

import numpy as np

from ..reference.canonical import canonical_code
from ..reference.control import contains_capped, mine_capped
from ..reference.reverse_search import mine_gtrace_rs


@dataclasses.dataclass
class MineOut:
    patterns: dict                   # pattern -> support, system classes
    device_seconds: Optional[float]  # the miner's own device clock


class ProgramSystem:
    """The port, ``repro_torch``, on ``device`` (``cuda`` in every
    benchmark run; the CPU only in the harness's own tests)."""

    name = "program"

    def __init__(self, device: str = "cuda"):
        from repro_torch.core import graphseq
        from repro_torch.mining.driver import AcceleratedMiner
        from repro_torch.serving import PatternServer, compile_bank

        self.device = device
        self._g = graphseq
        self._miner = AcceleratedMiner
        self._server = PatternServer
        self._compile = compile_bank

    def native(self, seqs):
        G = self._g
        return [
            tuple(tuple(G.TR(G.TRType(int(tr.type)), tr.u1, tr.u2, tr.label)
                        for tr in itemset) for itemset in s)
            for s in seqs
        ]

    def mine(self, db, sigma: int, max_len: int) -> MineOut:
        miner = self._miner(db, device=self.device)
        res = miner.mine_rs(sigma, max_len=max_len)
        return MineOut(res.patterns, miner.device_seconds)

    def server(self, patterns: dict, params: dict) -> "_ProgramServer":
        bank = self._compile(patterns)
        return _ProgramServer(bank, self._server(bank, device=self.device,
                                                 **params))

    def launches(self) -> Dict[str, int]:
        from repro_torch.kernels.containment import ops as cops
        from repro_torch.kernels.match_count import ops as mops

        return {"match_count": mops.launches, "contain_step": cops.launches}

    @contextlib.contextmanager
    def recording(self, calls: Dict[str, list], kernels: Dict):
        """Keep the inputs of every call of each kernel made inside the
        block (traced runs only: the roofline readers count each call's
        bytes and operations from them afterwards).  A kernel's roofline
        module names, in ``WRAPS``, the ``(module, function)`` of the
        port that launches it; the function is replaced by a recording
        wrapper there, where its callers look it up, and put back after."""
        import importlib

        saved = []

        def recorder(name, fn):
            def wrapper(*args):
                calls.setdefault(name, []).append(args)
                return fn(*args)
            return wrapper

        try:
            for name, mod in kernels.items():
                for path, attr in mod.WRAPS:
                    target = importlib.import_module(path)
                    fn = getattr(target, attr)
                    saved.append((target, attr, fn))
                    setattr(target, attr, recorder(name, fn))
            yield calls
        finally:
            for target, attr, fn in reversed(saved):
                setattr(target, attr, fn)


class _ProgramServer:
    def __init__(self, bank, srv):
        self.bank = bank
        self.srv = srv

    def query(self, seqs):
        return self.srv.query(seqs)

    def rows(self):
        return list(zip(self.bank.patterns, (int(s) for s in
                                             self.bank.support)))

    @staticmethod
    def answer(a):
        return a.contained, a.topk

    def counters(self) -> Dict[str, int]:
        st = self.srv.stats
        return {k: int(st[k]) for k in ("queries", "cache_hits",
                                        "host_fallback_cells")}


class ControlSystem:
    """The reference with its exactness broken, in the program's place.
    The mining control keeps ``per_seq`` embeddings a sequence; the
    serving control (``per_seq=None``) mines exactly and searches a
    frontier of the server's ``emax`` partial embeddings, so that what it
    breaks is the serving layer's alone."""

    name = "control"
    device = "cpu"

    def __init__(self, per_seq: Optional[int] = 1):
        self.per_seq = per_seq

    @staticmethod
    def native(seqs):
        return list(seqs)

    def mine(self, db, sigma: int, max_len: int) -> MineOut:
        if self.per_seq is None:
            return MineOut(mine_gtrace_rs(db, sigma, max_len).patterns, None)
        return MineOut(mine_capped(db, sigma, max_len, self.per_seq).patterns,
                       None)

    @staticmethod
    def server(patterns: dict, params: dict) -> "_ControlServer":
        return _ControlServer(patterns, params["emax"], params["topk"])

    @staticmethod
    def launches() -> Dict[str, int]:
        return {}

    @contextlib.contextmanager
    def recording(self, calls, kernels):
        yield calls


class _ControlServer:
    def __init__(self, patterns: dict, cap: int, k: int):
        self._rows = sorted(patterns.items(),
                            key=lambda ps: (-ps[1], canonical_code(ps[0])))
        self.cap = cap
        self.k = k
        self.n = 0

    def query(self, seqs):
        self.n += len(seqs)
        out = []
        for s in seqs:
            row = np.array([contains_capped(p, s, self.cap)
                            for p, _ in self._rows], bool)
            ids = np.nonzero(row)[0][: self.k]
            out.append((row, [(int(i), self._rows[i][1]) for i in ids]))
        return out

    def rows(self):
        return list(self._rows)

    @staticmethod
    def answer(a):
        return a

    def counters(self) -> Dict[str, int]:
        return {"queries": self.n}

