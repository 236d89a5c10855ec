"""Random contain_step inputs made with numpy from a seed (the
distribution of the JAX package's kernel test), shared by the CPU tests
against the JAX package and the tests on the card."""
import numpy as np

# (G, Ein, Tm): the JAX package's kernel-test shapes, root steps (Ein 1)
# and the escalation width (Ein 16)
SHAPES = [(1, 1, 1), (65, 8, 9), (40, 4, 16), (33, 1, 8), (17, 16, 5)]
# the kernel's edge shapes: Ein*Tm of 1, 8, 31, 33 and 512 (a cell over
# two blocks of 256 threads), G no multiple of the cells a block covers
EDGE_SHAPES = [(1000, 1, 1), (1001, 1, 8), (999, 1, 31), (777, 3, 11),
               (37, 16, 32)]


def contain_inputs(rng, G, E, Tm, NV=6):
    tok = np.zeros((G, Tm, 6), np.int32)
    tok[..., 0] = rng.integers(0, 6, (G, Tm))
    tok[..., 1] = rng.integers(0, 8, (G, Tm))
    tok[..., 2] = rng.integers(0, 8, (G, Tm))
    tok[..., 3] = rng.integers(-1, 4, (G, Tm))
    tok[..., 4] = np.sort(rng.integers(0, 6, (G, Tm)), axis=1)
    tok[..., 5] = rng.integers(0, 2, (G, Tm))
    psi = rng.integers(-2, 8, (G, E, NV)).astype(np.int32)
    srow = np.zeros((G, E, 8), np.int32)
    srow[..., 0] = rng.integers(0, 6, (G, E))
    srow[..., 1] = rng.integers(0, NV, (G, E))
    srow[..., 2] = rng.integers(0, NV, (G, E))
    srow[..., 3] = rng.integers(-1, 4, (G, E))
    srow[..., 4] = rng.integers(0, 2, (G, E))
    srow[..., 5] = rng.integers(-1, 6, (G, E))
    srow[..., 6] = rng.integers(-1, 6, (G, E))
    srow[..., 7] = rng.integers(0, 2, (G, E))
    return tok, psi, srow


def matching_inputs(rng, G, E, Tm, NV=6):
    """contain_inputs with the cheap gates passed, so that the psi
    lookups decide the masks: every token and step row valid, each token
    taking the type and label of one row of its cell, new rows open to
    any itemset slot (prev -1) and the others held to the slot of one of
    their cell's tokens, and psi unbound (negative) at about half its
    entries."""
    tok, psi, srow = contain_inputs(rng, G, E, Tm, NV)
    tok[..., 5] = 1
    srow[..., 7] = 1
    pick = rng.integers(0, E, (G, Tm))
    for f in (0, 3):
        tok[..., f] = np.take_along_axis(srow[..., f], pick, axis=1)
    new = srow[..., 4] > 0
    srow[..., 5] = np.where(new, -1, srow[..., 5])
    slot = np.take_along_axis(tok[..., 4], rng.integers(0, Tm, (G, E)),
                              axis=1)
    srow[..., 6] = np.where(new, srow[..., 6], slot)
    psi = np.where(rng.random(psi.shape) < 0.5, -2, psi).astype(np.int32)
    return tok, psi, srow
