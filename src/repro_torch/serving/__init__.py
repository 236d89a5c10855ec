"""Query-time pattern serving: from a ``MiningResult`` to exact
containment queries, on the card or the CPU.

Counterpart of the JAX package's ``repro.serving``:

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
* ``sharded.py`` - shard-by-pattern (flat) / shard-by-subtree (trie)
                   serving steps over a ``torch.distributed`` device
                   mesh (each rank joins its block; one all_gather
                   assembles the answer).
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
    BankCapacityError,
    PatternBank,
    bank_from_reference,
    canonical_sequence_map,
    compile_bank,
    extend_bank,
    sequence_fingerprint,
    slice_bank,
)
from .batch import (  # noqa: F401
    batch_contains,
    index_and_node_prescreen,
    index_and_prescreen,
    max_key_bucket,
    pair_contains,
    pair_contains_indexed,
    prescreen_counts,
    trie_contains,
    trie_level_advance,
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
from .layouts import (  # noqa: F401
    Layout,
    get_layout,
    layout_names,
    register_layout,
)
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
from .sharded import (  # noqa: F401
    make_serving_step,
    make_trie_serving_step,
    stack_trie_shards,
)
from .streaming import ObserveResult, StreamingBank  # noqa: F401
from .trie import (  # noqa: F401
    SubtreePack,
    TrieBank,
    build_trie,
    compile_trie_bank,
    extend_trie,
    masked_node_req,
    pack_subtrees,
    parent_prefix_hits,
)
