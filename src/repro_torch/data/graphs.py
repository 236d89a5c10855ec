"""Graph data: synthetic node-classification graphs, batched molecules,
and a real layer-wise neighbor sampler (GraphSAGE-style) for the
minibatch_lg shape."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def _with_self_loops_bidir(src, dst, n):
    s = np.concatenate([src, dst, np.arange(n)])
    d = np.concatenate([dst, src, np.arange(n)])
    return np.stack([s, d]).astype(np.int32)


def random_node_graph(
    rng: np.random.Generator, n_nodes: int, n_edges: int, d_feat: int,
    n_classes: int, label_frac: float = 0.5,
) -> Dict[str, np.ndarray]:
    src = rng.integers(0, n_nodes, n_edges)
    dst = rng.integers(0, n_nodes, n_edges)
    edges = _with_self_loops_bidir(src, dst, n_nodes)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    # features correlated with the label so training can learn
    centers = rng.normal(size=(n_classes, d_feat)).astype(np.float32)
    x = centers[labels] + 0.5 * rng.normal(size=(n_nodes, d_feat)).astype(
        np.float32
    )
    mask = (rng.random(n_nodes) < label_frac).astype(np.float32)
    return {"x": x, "edges": edges, "labels": labels, "mask": mask}


def random_molecule_batch(
    rng: np.random.Generator, n_graphs: int, nodes_per: int, edges_per: int,
    n_species: int = 10, n_classes: int = 2,
) -> Dict[str, np.ndarray]:
    N = n_graphs * nodes_per
    species = rng.integers(0, n_species, N).astype(np.int32)
    pos = rng.normal(size=(N, 3)).astype(np.float32) * 2.0
    srcs, dsts = [], []
    for g in range(n_graphs):
        off = g * nodes_per
        s = rng.integers(0, nodes_per, edges_per) + off
        d = rng.integers(0, nodes_per, edges_per) + off
        srcs.append(s)
        dsts.append(d)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    edges = np.stack(
        [np.concatenate([src, dst]), np.concatenate([dst, src])]
    ).astype(np.int32)
    graph_id = np.repeat(np.arange(n_graphs), nodes_per).astype(np.int32)
    return {
        "species": species,
        "pos": pos,
        "edges": edges,
        "graph_id": graph_id,
        "n_graphs": n_graphs,
        "targets": rng.normal(size=(n_graphs,)).astype(np.float32),
        "graph_labels": rng.integers(0, n_classes, n_graphs).astype(np.int32),
        # node features for non-geometric GNNs on the molecule shape
        "x": np.eye(n_species, dtype=np.float32)[species],
        "labels": np.zeros((N,), np.int32),
        "mask": np.zeros((N,), np.float32),
    }


class CSRGraph:
    """Compressed neighbor lists for host-side sampling."""

    def __init__(self, n_nodes: int, src: np.ndarray, dst: np.ndarray):
        order = np.argsort(src, kind="stable")
        self.nbr = dst[order].astype(np.int32)
        counts = np.bincount(src, minlength=n_nodes)
        self.offsets = np.concatenate([[0], np.cumsum(counts)]).astype(
            np.int64
        )
        self.n_nodes = n_nodes

    def sample_neighbors(self, rng, nodes: np.ndarray, fanout: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform with-replacement fanout sample; returns (src=neighbor,
        dst=node) edge arrays (padded with self loops for deg-0 nodes)."""
        starts = self.offsets[nodes]
        degs = self.offsets[nodes + 1] - starts
        r = rng.integers(0, np.maximum(degs, 1)[:, None],
                         (len(nodes), fanout))
        nbrs = self.nbr[
            (starts[:, None] + r).clip(0, len(self.nbr) - 1)
        ]
        nbrs = np.where(degs[:, None] > 0, nbrs, nodes[:, None])
        dst = np.repeat(nodes, fanout)
        return nbrs.reshape(-1).astype(np.int32), dst.astype(np.int32)


def sample_blocks(
    csr: CSRGraph, rng: np.random.Generator, seeds: np.ndarray,
    fanouts: Sequence[int], x: np.ndarray, labels: np.ndarray,
) -> Dict[str, np.ndarray]:
    """Layer-wise sampling -> one merged subgraph batch with relabeled
    node ids (seeds first), padded to a static size by the caller."""
    frontier = seeds.astype(np.int32)
    all_src: List[np.ndarray] = []
    all_dst: List[np.ndarray] = []
    nodes = [seeds.astype(np.int32)]
    for f in fanouts:
        s, d = csr.sample_neighbors(rng, frontier, f)
        all_src.append(s)
        all_dst.append(d)
        frontier = np.unique(s)
        nodes.append(frontier)
    uniq = np.unique(np.concatenate(nodes))
    # relabel with seeds occupying the first len(seeds) slots
    seed_set = np.zeros(csr.n_nodes + 1, bool)
    seed_set[seeds] = True
    rest = uniq[~seed_set[uniq]]
    order = np.concatenate([seeds, rest])
    remap = np.full(csr.n_nodes, -1, np.int32)
    remap[order] = np.arange(len(order), dtype=np.int32)
    src = remap[np.concatenate(all_src)]
    dst = remap[np.concatenate(all_dst)]
    n_sub = len(order)
    edges = _with_self_loops_bidir(src, dst, n_sub)
    mask = np.zeros(n_sub, np.float32)
    mask[: len(seeds)] = 1.0
    return {
        "x": x[order],
        "edges": edges,
        "labels": labels[order].astype(np.int32),
        "mask": mask,
    }


def pad_block(batch: Dict[str, np.ndarray], n_nodes: int, n_edges: int
              ) -> Dict[str, np.ndarray]:
    """Pad a sampled block to static shapes (adds edge_mask)."""
    nn = batch["x"].shape[0]
    ne = batch["edges"].shape[1]
    assert nn <= n_nodes and ne <= n_edges, (nn, n_nodes, ne, n_edges)
    out = {
        "x": np.pad(batch["x"], ((0, n_nodes - nn), (0, 0))),
        "edges": np.pad(batch["edges"], ((0, 0), (0, n_edges - ne))),
        "labels": np.pad(batch["labels"], (0, n_nodes - nn)),
        "mask": np.pad(batch["mask"], (0, n_nodes - nn)),
        "edge_mask": np.concatenate(
            [np.ones(ne, np.int32), np.zeros(n_edges - ne, np.int32)]
        ),
    }
    return out
