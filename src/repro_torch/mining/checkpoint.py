"""Fault-tolerant mining state: checkpoint / restore / resume.

Reverse search has no cross-subtree state, so the full miner state is
(mined results so far, remaining work stack).  We serialize both with
msgpack+zstd and write atomically (tmp + rename), so a crash at any point
leaves either the previous or the new checkpoint intact.  On restore the
driver resumes from the stack; subtree supports are recomputed
idempotently, so a re-enqueued subtree (e.g. after a lost worker) cannot
corrupt results.

``msgpack`` is imported only when a checkpoint is saved or loaded, so a
run that never checkpoints does not need it installed.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Tuple, Union

import zlib

try:
    import zstandard
except ImportError:  # optional dep: fall back to stdlib zlib
    zstandard = None

from ..core.enumerate_host import Emb
from ..core.graphseq import Pattern, TR, TRType
from .encoding import EmbBlock

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"


def _compress(raw: bytes) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(raw)
    return zlib.compress(raw, 6)


def _decompress(data: bytes) -> bytes:
    if data[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError(
                "checkpoint is zstd-compressed but zstandard is not installed"
            )
        return zstandard.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


def _pattern_to_wire(p: Pattern):
    return [sorted([list(tr) for tr in s]) for s in p]


def _pattern_from_wire(w) -> Pattern:
    return tuple(
        frozenset(TR(TRType(t[0]), t[1], t[2], t[3]) for t in s) for s in w
    )


def _emb_to_wire(e: Emb):
    gid, phi, psi = e
    return [gid, list(phi), [list(x) for x in psi]]


def _emb_from_wire(w) -> Emb:
    return (w[0], tuple(w[1]), tuple((a, b) for a, b in w[2]))


def save_state(
    path: str,
    patterns: Dict[Pattern, int],
    stack: List[Tuple[Pattern, Union[EmbBlock, List[Emb]]]],
    meta: dict | None = None,
) -> None:
    """Write the state atomically.  A stack entry's embeddings are an
    ``EmbBlock`` (the miner's work pool) or a list of ``Emb`` tuples;
    both go on the wire as tuples (version 1: gid, phi without pads,
    psi as ``[pv, dv]`` pairs), so either loads alike."""
    payload = {
        "version": 1,
        "meta": meta or {},
        "patterns": [[_pattern_to_wire(p), s] for p, s in patterns.items()],
        "stack": [
            [_pattern_to_wire(p),
             [_emb_to_wire(e) for e in (
                 embs.to_embs() if isinstance(embs, EmbBlock) else embs)]]
            for p, embs in stack
        ],
    }
    import msgpack

    raw = msgpack.packb(payload, use_bin_type=True)
    data = _compress(raw)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".ckpt-")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)  # atomic
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_state(path: str):
    """``(patterns, stack, meta)``; the stack's embeddings are lists of
    ``Emb`` tuples, which the miner encodes into blocks on resume."""
    import msgpack

    with open(path, "rb") as f:
        raw = _decompress(f.read())
    payload = msgpack.unpackb(raw, raw=False)
    assert payload["version"] == 1
    patterns = {
        _pattern_from_wire(w): s for w, s in payload["patterns"]
    }
    stack = [
        (_pattern_from_wire(w), [_emb_from_wire(e) for e in embs])
        for w, embs in payload["stack"]
    ]
    return patterns, stack, payload["meta"]
