"""Three-term roofline from the dry run's per-rank counts.

compute    = FLOPs_per_chip / peak_FLOPs
memory     = HBM_bytes_per_chip / HBM_bw
collective = collective_bytes_per_chip / link_bw

``launch.dryrun`` counts, for one rank's program traced under
``FakeTensorMode``, the FLOPs of every local op (``torch.utils.
flop_counter``'s registry), the bytes each op reads and writes, and the
result bytes of every collective by kind (``count_collective``, which
sums result sizes by kind as the JAX module's ``parse_collectives`` sums
them from the HLO); ``from_counts`` turns them into a ``Roofline``.
The bytes are eager, op by op: no fusion keeps an intermediate on chip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

# One NVIDIA H100 SXM5 (data sheet; nvidia-smi --query-gpu=name,
# power.limit: "NVIDIA H100 80GB HBM3, 700.00 W")
PEAK_FLOPS = 989.4e12   # bf16 dense, tensor cores
HBM_BW = 3.35e12        # bytes/s
LINK_BW = 450e9         # bytes/s, NVLink 4, one direction

# collective op name (c10d and _c10d_functional) -> XLA's kind
COLLECTIVE_KINDS = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "recv_": "collective-permute",
}
_NAMESPACES = ("c10d", "_c10d_functional")


def collective_kind(op) -> Optional[str]:
    """The kind of an op overload (``torch.ops.c10d.allreduce_.default``)
    that moves data between ranks, else None."""
    ns, name = op.namespace, op._opname
    return COLLECTIVE_KINDS.get(name) if ns in _NAMESPACES else None


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in a (nested) list or tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(x) for x in tree)
    return 0


def count_collective(table: Dict[str, Dict[str, float]], op, result) -> bool:
    """Add ``op``'s result bytes to ``table[kind]`` ({"bytes", "count"})
    when it is a collective; whether it was."""
    kind = collective_kind(op)
    if kind is None:
        return False
    d = table.setdefault(kind, {"bytes": 0.0, "count": 0})
    d["bytes"] += tensor_bytes(result)
    d["count"] += 1
    return True


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_chip: float
    n_chips: int
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_chip / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_chip * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful work / (chips x peak x achievable step time).  The
        achievable step time is the max of the three terms (perfect
        overlap assumption)."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.model_flops / (self.n_chips * PEAK_FLOPS * t)

    def to_dict(self) -> dict:
        extra = {}
        if hasattr(self, "collectives_by_kind"):
            extra["collectives_by_kind"] = self.collectives_by_kind
        return {
            **extra,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def from_counts(flops: float, hbm_bytes: float,
                collectives: Dict[str, Dict[str, float]], n_chips: int,
                model_flops: float) -> Roofline:
    """A ``Roofline`` from one rank's counts: its FLOPs, the bytes its
    ops read and write, and its collectives by kind (``count_collective``
    tables), whose result bytes sum to the collective term."""
    r = Roofline(
        flops_per_chip=float(flops),
        hbm_bytes_per_chip=float(hbm_bytes),
        collective_bytes_per_chip=float(
            sum(d["bytes"] for d in collectives.values())),
        n_chips=n_chips,
        model_flops=model_flops,
    )
    r.collectives_by_kind = collectives  # type: ignore[attr-defined]
    return r
