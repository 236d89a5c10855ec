"""Bank-layout registry: pluggable launch/finalize/escalate strategies.

A *layout* is how the pattern bank is organised for the device join -
``"flat"`` (one frontier per (sequence, pattern) pair), ``"trie"``
(per-level scan over the prefix trie) and ``"trie_fused"`` (the whole
trie walk in one kernel launch, kernels.trie_walk).  The
server, router, cluster and streaming layers used to dispatch on the
layout *string* at every seam; this registry replaces those if/else
chains with one ``Layout`` record carrying the strategy hooks, so a new
layout registers itself instead of growing every call site:

* ``prepare(server)``          - build layout-side tables at server init
                                 (trie levels, packed subtrees, ...),
* ``launch(server, seqs, shared)``   - dispatch one batch, return the
                                 ``InFlightRows`` (the async split's
                                 launch half),
* ``finalize(server, flight)`` - read the deferred device outputs back
                                 into the flight's host accumulators
                                 (escalation/oracle resolution is
                                 layout-independent and stays in
                                 ``PatternServer.finalize_rows``),
* ``escalate(server, flight)`` - the wider-frontier replay for
                                 the flight's overflow-undecided
                                 cells,
* ``on_mask(server)``          - refresh layout-side prescreen tables
                                 after a tombstone-mask change,
* ``place(bank, n_hosts, trie)`` - partition bank rows into per-shard
                                 contiguous groups (the cluster
                                 router's placement strategy).

``PatternServer`` registers the three built-in layouts at import time
(bottom of server.py - the hooks are its own methods); everything else
resolves layouts by name through ``get_layout``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List


@dataclasses.dataclass(frozen=True)
class Layout:
    """One bank layout's strategy hooks (see module docstring).

    ``uses_trie`` gates trie construction at every layer that wires a
    server up (streaming, cluster replicas): trie-shaped layouts need a
    ``TrieBank`` built over the pattern bank before launch."""

    name: str
    uses_trie: bool
    prepare: Callable
    launch: Callable
    finalize: Callable
    escalate: Callable
    on_mask: Callable
    place: Callable


_REGISTRY: Dict[str, Layout] = {}


def register_layout(layout: Layout) -> Layout:
    """Register (or replace) a layout under ``layout.name``."""
    _REGISTRY[layout.name] = layout
    return layout


def get_layout(name: str) -> Layout:
    """Resolve a layout by name; raises the same ``ValueError`` the old
    string checks did, now with the registered names listed."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown bank_layout {name!r} (registered: "
            f"{', '.join(sorted(_REGISTRY)) or 'none'})"
        ) from None


def layout_names() -> List[str]:
    return sorted(_REGISTRY)
