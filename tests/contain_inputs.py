"""Random contain_step inputs made with numpy from a seed (the
distribution of the JAX package's kernel test), shared by the CPU tests
against the JAX package and the tests on the card."""
import numpy as np

# (G, Ein, Tm): the JAX package's kernel-test shapes, root steps (Ein 1)
# and the escalation width (Ein 16)
SHAPES = [(1, 1, 1), (65, 8, 9), (40, 4, 16), (33, 1, 8), (17, 16, 5)]


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
