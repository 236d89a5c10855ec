"""Bytes and int32 operations of one ``match_count`` launch (the miner's
device scan, ``csrc/match_count.cu``), from the call's inputs.

Bytes: each gathered token row and pattern table the chunk references
read once, the per-row and per-pattern inputs, the output written once.
Operations: per active (row, token) pair two psi lookups, the phi
position and gap count and about 30 scalar ops (gates, slot, packing);
for in-itemset slots, 5 compares per row of the pattern's table that can
match.  The same counts as the kernel table of PERF.md.
"""
KERNEL = "match_count_kernel"   # the device kernel's name on the timeline
# the port's function that launches it, as its callers look it up
WRAPS = [("repro_torch.mining.driver", "match_signatures_batch")]


def _index(idx, n):
    """Indices as the kernel reads them: wrapped once when negative, then
    clamped into ``[0, n - 1]``."""
    import torch

    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, max(n - 1, 0))


def launched(tokens, gid, phi, psi, emb_valid, pid, ex_stack, nv_stack,
             npat_stack, mode_stack) -> bool:
    return gid.shape[0] > 0 and tokens.shape[1] > 0


def counts(tokens, gid, phi, psi, emb_valid, pid, ex_stack, nv_stack,
           npat_stack, mode_stack):
    import torch

    T = tokens.shape[1]
    E, NI = phi.shape
    NV = psi.shape[1]
    P = ex_stack.shape[1]
    g = _index(gid, tokens.shape[0])
    p = _index(pid, ex_stack.shape[0])
    n_g = int(torch.unique(g).numel())
    n_p = int(torch.unique(p).numel())
    nbytes = 4 * (n_g * T * 6 + n_p * P * 5 + E * (NI + NV + 3)
                  + 3 * n_p + E * T)
    tok = tokens[g]                                     # [E,T,6]
    active = (tok[..., 5] > 0) & (emb_valid[:, None] > 0)
    in_any = (phi[:, None, :] == tok[..., 4:5]).any(-1) & active
    real = (ex_stack[..., 0] >= 0).sum(-1)[p]           # [E]
    ops = (int(active.sum()) * (2 * NV + 2 * NI + 30)
           + 5 * int((in_any.sum(-1) * real).sum()))
    return nbytes, ops
