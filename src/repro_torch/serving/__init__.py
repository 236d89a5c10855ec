"""Query-time pattern serving on one host: from a ``MiningResult`` to
exact containment queries, on the card or the CPU.

Counterpart of the JAX package's ``repro.serving``; the sharded
multi-device serving step (``sharded.py``) is still to come:

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
* ``streaming.py`` - ``StreamingBank``: exact supports over a sliding
                   window, tombstones, incremental frontier refresh
                   (``mining.incremental``), read-replica deltas.
* ``router.py``  - bank placement and ``ClusterRouter``: routed and
                   async (continuous-batching) joins over bank shards,
                   two cache levels, the shed tier, retries, breakers.
* ``faults.py``  - the seeded fault injector, fault types, retry policy
                   and the replicas' recovery log.
* ``cluster.py`` - ``ServingCluster``, the sharded window
                   (``ShardedStreamingBank``) and ``ReplicaGroup``, over
                   simulated hosts pinned to torch devices.
"""
from .bank import (  # noqa: F401
    PatternBank,
    bank_from_reference,
    compile_bank,
    sequence_fingerprint,
)
from .cluster import (  # noqa: F401
    BankReplica,
    ClusterHost,
    ReplicaGroup,
    ServingCluster,
    ShardedStreamingBank,
)
from .faults import (  # noqa: F401
    FaultInjector,
    HostDownError,
    HostFault,
    HostTimeoutError,
    HostUnavailableError,
    PipelineBusyError,
    RecoveryLog,
    RetryPolicy,
    TransientHostError,
)
from .join import Frontend, JoinRequest, JoinResult  # noqa: F401
from .layouts import Layout, get_layout, layout_names  # noqa: F401
from .router import (  # noqa: F401
    BankPlacement,
    ClusterRouter,
    DrainTicket,
    plan_placement,
)
from .server import (  # noqa: F401
    InFlightRows,
    PatternServer,
    QueryResult,
    SharedEncoding,
    encode_queries,
)
from .streaming import ObserveResult, StreamingBank  # noqa: F401
from .trie import TrieBank, build_trie, pack_subtrees  # noqa: F401
