"""Query-time pattern serving on one host: from a ``MiningResult`` to
exact containment queries, on the card or the CPU.

Counterpart of the JAX package's ``repro.serving``, ported so far for
the single-host path (the streaming window, the router, the fault layer
and the cluster are still to come):

* ``bank.py``    - compile a ``MiningResult`` into a packed pattern bank
                   (per-pattern int32 step programs + support/metadata
                   rows) and renaming-invariant sequence fingerprints;
                   ``bank_from_reference`` carries a bank compiled by
                   the JAX package across.
* ``trie.py``    - the prefix-trie re-layout of a bank with per-node
                   residual ``node_req`` prescreen rows, and the packed
                   subtree shards of the fused walk.
* ``batch.py``   - the embedding-join scans: flat per-(sequence,
                   pattern) joins, the level-synchronous trie join, the
                   fused trie walk, the counts prescreens and the
                   inverted token index.  The predicate is the
                   containment kernel (``kernels.containment``) and the
                   fused walk the trie-walk kernel
                   (``kernels.trie_walk``) on a CUDA device.
* ``layouts.py`` - the ``Layout`` registry (``"flat"``, ``"trie"``,
                   ``"trie_fused"``).
* ``join.py``    - the ``JoinRequest -> JoinResult`` protocol and the
                   ``Frontend`` facade.
* ``server.py``  - ``PatternServer``: batching, prescreen + join under
                   any registered layout, fingerprint LRU cache, top-k
                   scoring, device escalation + host-oracle fallback, so
                   results always equal ``core.containment``.
"""
from .bank import (  # noqa: F401
    PatternBank,
    bank_from_reference,
    compile_bank,
    sequence_fingerprint,
)
from .join import Frontend, JoinRequest, JoinResult  # noqa: F401
from .layouts import Layout, get_layout, layout_names  # noqa: F401
from .server import (  # noqa: F401
    InFlightRows,
    PatternServer,
    QueryResult,
    SharedEncoding,
    encode_queries,
)
from .trie import TrieBank, build_trie, pack_subtrees  # noqa: F401
