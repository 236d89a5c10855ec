"""Checks of the port's GNN, MACE and BERT4Rec families, shared by the CPU
tests (``tests/test_torch_gnn.py``, ``test_torch_mace.py``,
``test_torch_recsys.py``) and ``chip_smoke.py`` (phase 12).  Imports
torch and the port only.

It also holds the port's side of ``examples/recsys_patterns.py``: user
sessions become graph sequences, are mined (match_count), served by a
``PatternServer`` (contain_step or trie_walk), pooled by
``embedding_bag`` and scored by BERT4Rec's chunked top-k.

Each check raises AssertionError on a difference past its tolerance and
returns the largest differences it saw.
"""
from __future__ import annotations

import random

import numpy as np
import torch

from repro_torch.configs.registry import get_arch
from repro_torch.core.compile import compile_sequence
from repro_torch.core.containment import contains
from repro_torch.core.graphseq import LabeledGraph
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.models import bert4rec as b4r
from repro_torch.models.common import tree_leaves, tree_leaves_with_path, \
    tree_map, value_and_grad
from repro_torch.models.embedding import embedding_bag
from repro_torch.serving import PatternServer, compile_bank
from torch_lm_checks import _max_err

# the family smoke steps, cuda vs the CPU at fp32: loss and grads
# norm-wise (``_norm_err``); the optimizer's update on the same grads
# element-wise (atol and rtol)
SMOKE_GRAD_TOL, SMOKE_UPDATE_TOL = 1e-5, 1e-6
# a train step's loss and grads on the card against the CPU, fp32,
# norm-wise
STEP_TOL = 1e-4
# tests/test_archs.py::test_mace_rotation_invariance
ROT_RTOL, ROT_ATOL = 2e-4, 2e-5
# a top-k list against brute force: equal as sets where the k-th and
# (k+1)-th scores differ by more than this
TOPK_GAP = 1e-5
FAMILY_IDS = ("gcn-cora", "gat-cora", "gin-tu", "mace", "bert4rec")
# examples/recsys_patterns.py: 60 sessions, sigma 12, max_len 4, the
# top-8 bank, BERT4Rec's demo config
N_SESSIONS, SIGMA, MAX_LEN, TOP = 60, 12, 4, 8
DEMO = dict(n_items=64, seq_len=8, v_chunk=32, topk=5)


def _norm_err(got, want, tol):
    """Largest ``max |got - want| / max(1, max |want|)`` over the leaves
    of two trees, raising past ``tol``.  Norm-wise, leaf by leaf: the
    family models' grads reach 1e2 (GIN's unnormalized sums) to 1e5
    (MACE's cubic invariants), and fp32 rounding alone moves them by
    that scale times ~1e-7 (the CPU's fp32 against fp64), so an
    element-wise tolerance would judge the order of the sums."""
    worst = 0.0
    flat = dict(tree_leaves_with_path(want))
    for path, g in tree_leaves_with_path(got):
        w = flat[path].to(g.device).float()
        err = float((g.float() - w).abs().max()) if g.numel() else 0.0
        rel = err / max(1.0, float(w.abs().max()) if w.numel() else 0.0)
        if not rel <= tol:
            raise AssertionError(
                f"{'/'.join(map(str, path))}: max |diff| {err:.3g} is "
                f"{rel:.3g} of the leaf's scale, past {tol}")
        worst = max(worst, rel)
    return worst


def family_smoke_vs_cpu(arch_id: str) -> dict:
    """The arch's smoke step on ``cuda`` against the CPU from the same
    weights and batch: loss and grads within ``SMOKE_GRAD_TOL``
    (``_norm_err``); the
    arch's optimizer applied on the card to the CPU's grads, params and
    moments within ``SMOKE_UPDATE_TOL`` of the CPU's update; then the
    step itself on the card: a finite loss, params moved."""
    arch = get_arch(arch_id)
    step_c, (params_c, opt_c, batch_c) = arch.smoke_bundle(device="cuda")
    step_h, (params_h, opt_h, batch_h) = arch.smoke_bundle(device="cpu")
    vg = value_and_grad(step_h.loss_fn)
    loss_c, g_c = vg(params_c, batch_c)
    loss_h, g_h = vg(params_h, batch_h)
    out = {"loss": _norm_err({"l": loss_c}, {"l": loss_h}, SMOKE_GRAD_TOL),
           "grads": _norm_err(g_c, g_h, SMOKE_GRAD_TOL)}
    opt = arch.optimizer()
    new_h, state_h = opt.update(g_h, opt.init(params_h), params_h)
    g_on_card = tree_map(lambda g: g.to("cuda"), g_h)
    new_c, state_c = opt.update(g_on_card, opt.init(params_c), params_c)
    out["update"] = max(_max_err(new_c, new_h, SMOKE_UPDATE_TOL),
                        _max_err(state_c.m, state_h.m, SMOKE_UPDATE_TOL),
                        _max_err(state_c.v, state_h.v, SMOKE_UPDATE_TOL))
    loss, moved, _ = step_c(params_c, opt_c, batch_c)
    worst = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(params_c), tree_leaves(moved)))
    if not (np.isfinite(float(loss)) and worst > 0):
        raise AssertionError(f"{arch_id} step: loss {float(loss)}, params "
                             f"moved {worst}")
    out.update(loss_cuda=float(loss_c), loss_cpu=float(loss_h))
    return out


def step_vs_cpu(loss_fn, params, batch, tol: float = STEP_TOL) -> dict:
    """``loss_fn``'s value and grads at ``params`` on their device against
    the same on CPU copies of ``params`` and ``batch``: within ``tol``
    (``_norm_err``).  Returns the largest differences and the loss."""
    vg = value_and_grad(loss_fn)
    loss, grads = vg(params, batch)
    cpu = tree_map(lambda x: x.cpu(), params)
    cbatch = {k: v.cpu() if isinstance(v, torch.Tensor) else v
              for k, v in batch.items()}
    loss_h, grads_h = vg(cpu, cbatch)
    return {"loss": float(loss),
            "loss_err": _norm_err({"l": loss}, {"l": loss_h}, tol),
            "grads_err": _norm_err(grads, grads_h, tol)}


def random_rotation(seed: int) -> torch.Tensor:
    """A proper rotation: the Q of a Gaussian 3x3 (numpy ``seed``),
    signed so that det = +1."""
    g = np.random.default_rng(seed).normal(size=(3, 3))
    q, _ = np.linalg.qr(g)
    q = q * np.sign(np.linalg.det(q))
    return torch.as_tensor(q, dtype=torch.float32)


def rotation_invariance(forward, params, batch, seed: int = 7) -> float:
    """``forward``'s energies before and after a random rotation
    (``random_rotation(seed)``) and the translation (1, -2, 0.5) of
    ``batch["pos"]``: within ``ROT_RTOL`` / ``ROT_ATOL``.  Returns the
    largest difference."""
    pos = batch["pos"]
    q = random_rotation(seed).to(pos.device)
    moved = dict(batch, pos=pos @ q.T + torch.tensor(
        [1.0, -2.0, 0.5], device=pos.device))
    with torch.no_grad():
        e0, e1 = forward(params, batch), forward(params, moved)
    err = (e1 - e0).abs()
    if bool((err > ROT_ATOL + ROT_RTOL * e0.abs()).any()) or \
            not bool(torch.isfinite(e0).all()):
        raise AssertionError(f"energy moved by {float(err.max()):.3g} "
                             "under a rotation and translation")
    return float(err.max())


def topk_vs_bruteforce(emb, query, ids, cfg, rows: int = 512) -> int:
    """Each row's ``ids`` (from ``chunked_topk_scores``) against a
    brute-force ``query @ emb[1:n_items+1].T`` top-k on the same device,
    ``rows`` queries at a time: equal as sets wherever the k-th and
    (k+1)-th brute-force scores differ by more than ``TOPK_GAP``.
    Returns the number of rows held (the rest sit on a near tie)."""
    k = cfg.topk
    cat = emb[1:cfg.n_items + 1].to(query.dtype)
    held = 0
    with torch.no_grad():
        for lo in range(0, query.shape[0], rows):
            sc = query[lo:lo + rows] @ cat.T
            top_s, top_i = torch.topk(sc, k + 1, dim=-1)
            gap = top_s[:, k - 1] - top_s[:, k]
            want = torch.sort(top_i[:, :k] + 1, -1).values
            got = torch.sort(ids[lo:lo + rows].long(), -1).values
            firm = gap > TOPK_GAP
            bad = firm & (want != got).any(-1)
            if bool(bad.any()):
                r = lo + int(bad.nonzero()[0, 0])
                raise AssertionError(f"row {r}: top-{k} ids differ from "
                                     "brute force")
            held += int(firm.sum())
    return held


# ------------------------------------------------ examples/recsys_patterns
def session_to_graphseq(items, rng, n_cats=5):
    """A session becomes a graph sequence: each step adds the interacted
    item (vertex labeled by category) linked to the previous item."""
    g = LabeledGraph()
    seq = []
    prev = None
    for it in items:
        if it not in g.vlabels:
            g.add_vertex(it, it % n_cats)
        if prev is not None and prev != it:
            e = (min(prev, it), max(prev, it))
            if e not in g.elabels:
                g.add_edge(prev, it, 0)
        prev = it
        seq.append(g.copy())
    return seq


def example_sessions():
    """The example's 60 sessions (``random.Random(0)``) and their
    compiled graph sequences."""
    rng = random.Random(0)
    sessions = []
    for _ in range(N_SESSIONS):
        base = rng.randrange(4) * 10
        sessions.append([base + rng.randrange(4) for _ in range(5)])
    db = [compile_sequence(session_to_graphseq(s, rng)) for s in sessions]
    return sessions, db


def session_seqs(sessions, cfg: b4r.Bert4RecConfig) -> np.ndarray:
    """Item ids 1.. of each session, cut or padded with 0 to seq_len."""
    s = cfg.seq_len
    return np.asarray(
        [[min(i + 1, cfg.n_items) for i in x[:s]] + [0] * (s - len(x[:s]))
         for x in sessions], np.int32)


def recsys_integration(params, pat_table, cfg, device,
                       layouts=("flat",)) -> dict:
    """The example's chain on ``device``: mine the sessions (sigma 12,
    max_len 4), compile the top-8 bank and serve it under each of
    ``layouts`` (the feature matrices must be equal, and equal to the
    host oracle ``contains``), pool each session's pattern ids with
    ``embedding_bag`` (mean) over ``pat_table``, and score the
    BERT4Rec query (last position + pattern embedding) with
    ``chunked_topk_scores``."""
    sessions, db = example_sessions()
    miner = AcceleratedMiner(db, device=device)
    res = miner.mine_rs(min_support=SIGMA, max_len=MAX_LEN)
    bank = compile_bank(res, top=TOP)
    feats = {}
    for layout in layouts:
        srv = PatternServer(bank, topk=8, bank_layout=layout, device=device)
        feats[layout] = np.stack(
            [r.contained for r in srv.query(db)]).astype(np.float32)
    f = feats[layouts[0]]
    oracle = np.array([[contains(p, s) for p in bank.patterns] for s in db],
                      np.float32)
    for layout, got in feats.items():
        if not np.array_equal(got, oracle):
            raise AssertionError(f"{layout}: the feature matrix differs "
                                 "from the host oracle's")
    seqs = torch.as_tensor(session_seqs(sessions, cfg), device=device)
    with torch.no_grad():
        hidden = b4r.encode(params, seqs, cfg)
        nz = np.nonzero(f)
        pat_emb = embedding_bag(
            pat_table, torch.as_tensor(nz[1], dtype=torch.int32,
                                       device=device),
            torch.as_tensor(nz[0], dtype=torch.int32, device=device),
            len(db), mode="mean")
        query = hidden[:, -1] + pat_emb
        scores, ids = b4r.chunked_topk_scores(params, query, cfg)
    return {"res": res, "bank": bank, "feats": f, "query": query,
            "scores": scores, "ids": ids, "device_calls": miner.n_device_calls}
