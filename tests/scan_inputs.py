"""Random match_count scan inputs made with numpy from a seed, shared by
the CPU tests against the JAX package and the tests on the card."""
import numpy as np

from repro_torch.mining.encoding import PAD_PHI, PAD_PSI

# the (E, T) sweep of the JAX package's kernel tests
SHAPES = [(1, 1), (3, 7), (64, 128), (65, 129), (128, 60), (17, 300)]


def scan_inputs(rng, E, G, T, NI, NV, P, NP):
    """Per-row scan inputs: random tokens (pad tokens included), embedding
    rows with PAD_PHI / PAD_PSI columns and padded rows (emb_valid 0),
    mixed pattern ids, and existing tables holding real TR rows so the
    duplicate rejection fires."""
    tokens = np.zeros((G, T, 6), np.int32)
    tokens[..., 0] = rng.integers(0, 6, (G, T))
    tokens[..., 1] = rng.integers(0, 8, (G, T))
    tokens[..., 2] = np.where(
        tokens[..., 0] >= 3, rng.integers(0, 8, (G, T)), -1)
    tokens[..., 2] = np.where(
        (tokens[..., 0] >= 3) & (tokens[..., 2] == tokens[..., 1]),
        (tokens[..., 2] + 1) % 8, tokens[..., 2])
    tokens[..., 3] = rng.integers(-1, 5, (G, T))
    tokens[..., 4] = np.sort(rng.integers(0, 6, (G, T)), axis=1)
    tokens[..., 5] = rng.integers(0, 2, (G, T))
    pad_tok = rng.random((G, T)) < 0.2  # encode_db's pad rows
    tokens[pad_tok] = (0, -1, -1, -1, 0, 0)
    gid = rng.integers(0, G, (E,)).astype(np.int32)
    phi = np.sort(rng.integers(0, 6, (E, NI)), axis=1).astype(np.int32)
    n_it = rng.integers(0, min(NI, 4) + 1, (E,))
    phi[np.arange(NI)[None, :] >= n_it[:, None]] = PAD_PHI
    psi = np.full((E, NV), PAD_PSI, np.int32)
    for e in range(E):
        m = int(rng.integers(0, min(NV, 8) + 1))
        psi[e, :m] = rng.permutation(8)[:m]
    valid = (rng.random(E) < 0.8).astype(np.int32)
    pid = rng.integers(0, NP, (E,)).astype(np.int32)
    ex_stack = np.full((NP, P, 5), -9, np.int32)
    for p in range(NP):
        k = int(rng.integers(0, min(P, 6) + 1))
        ex_stack[p, :k, 0] = rng.integers(0, 3, k)
        ex_stack[p, :k, 1] = rng.integers(0, 6, k)
        ex_stack[p, :k, 2] = rng.integers(0, 4, k)
        ex_stack[p, :k, 3] = np.where(ex_stack[p, :k, 1] <= 2, 15,
                                      rng.integers(0, 5, k))
        ex_stack[p, :k, 4] = rng.integers(-1, 5, k)
    nv_stack = rng.integers(0, 6, (NP,)).astype(np.int32)
    npat_stack = rng.integers(0, 4, (NP,)).astype(np.int32)
    return tokens, gid, phi, psi, valid, pid, ex_stack, nv_stack, npat_stack
