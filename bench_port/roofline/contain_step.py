"""Bytes and int32 operations of one ``contain_step`` launch (the serving
join's predicate, ``csrc/containment.cu``), from the call's inputs.

Bytes: each input read once and the ``[G, Ein, Tm]`` output written
once.  Operations: about 10 per (cell, row, token) triple for the type,
label and itemset-slot gates, and 3 NV + 20 more for the psi lookups and
orientation tests of the triples that pass them.  The same counts as the
kernel table of PERF.md.
"""
KERNEL = "contain_step_kernel"  # the device kernel's name on the timeline
# the port's function that launches it, as its callers look it up
WRAPS = [("repro_torch.serving.batch", "contain_step")]


def launched(tok, psi, srow) -> bool:
    return tok.shape[0] * psi.shape[1] * tok.shape[1] > 0


def _gates(tok, srow):
    t = tok[:, None, :, :]
    r = srow[:, :, None, :]
    return ((t[..., 5] > 0) & (r[..., 7] > 0) & (t[..., 0] == r[..., 0])
            & (t[..., 3] == r[..., 3])
            & ((r[..., 4] > 0) & (t[..., 4] > r[..., 5])
               | (r[..., 4] <= 0) & (t[..., 4] == r[..., 6])))


def counts(tok, psi, srow):
    G, Tm, _ = tok.shape
    _, Ein, NV = psi.shape
    nbytes = 4 * (tok.numel() + psi.numel() + srow.numel() + G * Ein * Tm)
    ops = G * Ein * Tm * 10 + int(_gates(tok, srow).sum()) * (3 * NV + 20)
    return nbytes, ops
