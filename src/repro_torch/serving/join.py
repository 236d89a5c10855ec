"""The unified Join API: ``JoinRequest -> JoinResult`` on every backend.

The serving stack grew one entry-point dialect per layer -
``PatternServer.query/query_one/exact_rows``, ``ClusterRouter.route/
submit/collect``, ``ServingCluster.query/query_multi``,
``StreamingBank.query`` - each with its own defaults for k, exactness
and batching.  This module is the one protocol they all speak now:

* ``JoinRequest`` - the sequences to join, the top-k depth, the
  exactness contract (``exact=False`` asks for the prescreen-only
  approximate tier: a sound overapproximation, flagged per-result,
  never cached), an optional trace id stitched into the obs layer, and
  the arrival host (cluster backends).
* ``JoinResult`` - the per-sequence ``QueryResult`` list in request
  order plus batch-level views (``rows``, ``exact``).
* every backend implements ``join(JoinRequest) -> JoinResult``; the
  legacy methods survive as thin wrappers over it, so existing callers
  and tests run unmodified.
* ``Frontend`` - a facade that speaks the protocol against any backend
  uniformly, including a begin/finish split for backends with an async
  pipeline (``submit``/``collect`` or ``launch_rows``/
  ``finalize_rows``).

Exactness propagation is part of the protocol: a backend must flag
every approximate row on the ``QueryResult`` (``exact=False``), no
matter which layer produced it - server approx tier, router shed tier,
or a streaming/replica rescore of either.  The differential tests
assert this on every entry point.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..core.graphseq import TRSeq
from ..obs import trace
from .bank import sequence_fingerprint
from .server import QueryResult


@dataclasses.dataclass(frozen=True)
class JoinRequest:
    """One containment-join request batch (see module docstring).

    ``k=None`` means the backend's configured top-k depth.  ``host``
    names the arrival host for cluster backends (single-host backends
    ignore it).  ``timeout`` bounds the async drain (``Frontend``'s
    begin/finish over a router/cluster backend): past the deadline the
    backend answers the stragglers from its degraded tier, flagged
    ``exact=False``, instead of blocking - see
    ``ClusterRouter.collect``.  Backends without a timeout notion
    ignore it."""

    seqs: Tuple[TRSeq, ...]
    k: Optional[int] = None
    exact: bool = True
    trace_id: Optional[str] = None
    host: int = 0
    timeout: Optional[float] = None

    def __post_init__(self):
        object.__setattr__(self, "seqs", tuple(self.seqs))

    def __len__(self) -> int:
        return len(self.seqs)


@dataclasses.dataclass
class JoinResult:
    """Per-sequence results in request order, plus batch views."""

    results: List[QueryResult]

    @property
    def exact(self) -> bool:
        """True iff every row honours the exact-containment contract."""
        return all(r.exact for r in self.results)

    @property
    def rows(self) -> np.ndarray:
        """[n_seqs, n_patterns] containment matrix, request order."""
        if not self.results:
            return np.zeros((0, 0), bool)
        return np.stack([r.contained for r in self.results])

    def __len__(self) -> int:
        return len(self.results)


def join_span(req: JoinRequest, backend: str):
    """The obs span stitching a request's ``trace_id`` into the trace
    stream; a no-op context when the request carries none."""
    if req.trace_id is None:
        return contextlib.nullcontext()
    return trace.span("serving.join", trace_id=req.trace_id,
                      backend=backend, n=len(req.seqs))


class Frontend:
    """One facade over any join backend (server, router, cluster,
    streaming bank, replica): speak ``JoinRequest``/``JoinResult``
    without caring which layer answers.

    ``begin``/``finish`` expose the backend's async pipeline when it
    has one: routers/clusters go through ``submit``/``collect``
    (continuous batching, shed tier and all), plain servers through the
    cache-bypassing ``launch_rows``/``finalize_rows`` split, and
    anything else falls back to computing at ``begin`` time - callers
    get overlap when the backend offers it and identical results when
    it does not."""

    def __init__(self, backend: Any):
        self.backend = backend

    # ------------------------------------------------------------- sync
    def join(self, req: JoinRequest) -> JoinResult:
        return self.backend.join(req)

    def query(self, seqs: Sequence[TRSeq], k: Optional[int] = None, *,
              exact: bool = True, host: int = 0,
              trace_id: Optional[str] = None) -> List[QueryResult]:
        return self.join(JoinRequest(
            seqs=tuple(seqs), k=k, exact=exact, host=host,
            trace_id=trace_id,
        )).results

    def query_one(self, seq: TRSeq, k: Optional[int] = None,
                  **kw) -> QueryResult:
        return self.query([seq], k, **kw)[0]

    def rows(self, seqs: Sequence[TRSeq], *, exact: bool = True,
             host: int = 0) -> np.ndarray:
        """[n_seqs, n_patterns] containment matrix."""
        return self.join(JoinRequest(
            seqs=tuple(seqs), k=0, exact=exact, host=host,
        )).rows

    # ------------------------------------------------------------ async
    def begin(self, req: JoinRequest):
        """Admit a request without blocking; redeem with ``finish``.
        Approximate requests compute immediately (the approx tier is
        host-only: there is nothing to overlap)."""
        backend = self.backend
        if req.exact and hasattr(backend, "submit"):
            ticket = backend.submit({req.host: list(req.seqs)}, k=req.k)
            return ("ticket", req, ticket)
        if req.exact and hasattr(backend, "launch_rows"):
            # cache-bypassing flights, chunked like exact_rows; results
            # are built (and cached) at finish time
            flights = []
            for c0 in range(0, len(req.seqs), backend.max_batch):
                chunk = list(req.seqs[c0 : c0 + backend.max_batch])
                flights.append(backend.launch_rows(chunk))
            return ("flights", req, flights)
        return ("done", req, self.join(req))

    def finish(self, handle) -> JoinResult:
        kind, req, payload = handle
        if kind == "done":
            return payload
        if kind == "ticket":
            results = self.backend.collect(
                payload, timeout=req.timeout)[req.host]
            return JoinResult(results)
        backend = self.backend
        k = backend.topk if req.k is None else req.k
        results: List[QueryResult] = []
        for flight in payload:
            got = backend.finalize_rows(flight)
            for i, s in enumerate(flight.seqs):
                row = got[i]
                results.append(QueryResult(
                    fingerprint=sequence_fingerprint(s),
                    contained=row, topk=backend._score(row, k),
                ))
        return JoinResult(results)
