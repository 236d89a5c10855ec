"""The original GTRACE (baseline, Sec. 2.2-2.3).

PrefixSpan-style tail growth over *all* frequent transformation
subsequences (FTSs), followed by the relevance postfilter.  This is the
method the paper is orders of magnitude faster than; we need it both as
the correctness oracle (its postfiltered output must equal GTRACE-RS's
output) and as the comparison baseline for the Table-4/5 benchmarks.

Duplicate patterns (same canonical class reached through different raw
vertex labelings) are pruned with a canonical seen-set; supports are exact
because every raw key's occurrence list is complete for the child pattern.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence

from .canonical import canonical_code, canonical_form, canonical_map
from .enumerate_host import (
    apply_extension,
    find_extensions,
    merge_extensions_by_canonical,
    root_embeddings,
)
from .graphseq import Pattern, TRSeq, pattern_length
from .union_graph import is_relevant


@dataclass
class MiningResult:
    patterns: Dict[Pattern, int] = field(default_factory=dict)  # canonical -> support
    n_enumerated: int = 0  # nodes expanded (FTSs for GT, rFTSs for RS)
    n_extension_scans: int = 0

    def relevant(self) -> Dict[Pattern, int]:
        return {p: s for p, s in self.patterns.items() if is_relevant(p)}


def mine_gtrace(
    db: Sequence[TRSeq],
    min_support: int,
    max_len: int | None = None,
) -> MiningResult:
    """Mine all FTSs (result.patterns), callers filter via .relevant()."""
    res = MiningResult()
    seen = set()

    def allow_all(slot, tr) -> bool:
        return True

    stack = [((), root_embeddings(db))]
    while stack:
        pattern, embs = stack.pop()
        if max_len is not None and pattern_length(pattern) >= max_len:
            continue
        res.n_extension_scans += 1
        exts = find_extensions(pattern, embs, db, allow_all, tail_only=True)
        for child, (gids, child_embs) in merge_extensions_by_canonical(
            pattern, exts
        ).items():
            if len(gids) < min_support:
                continue
            if child in seen:
                continue
            seen.add(child)
            res.patterns[child] = len(gids)
            res.n_enumerated += 1
            stack.append((child, child_embs))
    return res
