"""Random inputs of the join step's compaction (``kernels.step_compact``)
made with numpy from a seed, shared by the CPU tests, the tests on the
card and ``chip_smoke.py``."""
import numpy as np
import torch

from repro_torch.serving.batch import _step_ranges

# (emax, Ein, Tm): the main path's frontier widths 4 (first pass) and 16
# (escalation replay), each from the root frontier (Ein 1) and from a
# full one (Ein = emax); a window of one; and 16 x 33 masks, 17 ballot
# rounds of a warp
SHAPES = [(4, 1, 8), (4, 4, 8), (16, 1, 16), (16, 16, 16), (4, 4, 1),
          (16, 16, 33)]
MODES = ["compact", "terminal", "terminal_count"]
N_CELLS, NI, NV, L = 67, 6, 5, 3


def mode_kw(mode):
    """The step's keywords for one of ``MODES``."""
    return dict(compact=mode == "compact",
                count_frontier_ovf=mode == "terminal_count")


def compact_inputs(seed, N, emax, Ein, Tm, p_match=0.2, device="cpu"):
    """Random inputs of one step for N cells on ``device``, as
    ``_step_once`` hands them over: masks with cell 0 accepting nothing
    and cell 1 every candidate, frontiers with invalid rows, window
    counts past ``Tm``, and step rows whose itemset slot and pattern
    vertices fall in range, negative (wrapped once or not) and past the
    end.  The step rows are column ``k`` of an [N, L, 8] program and
    ``pu_c`` / ``pu_ok`` come from ``_step_ranges`` over it, so they are
    the strided views the join passes.  The same seed gives the same
    values on every device.  Returns ``(args, {emax, tmax})``."""
    rng = np.random.default_rng(seed)
    hit = rng.random((N, Ein, Tm)) < p_match
    bits = np.where(hit, rng.integers(1, 4, (N, Ein, Tm)), 0)
    bits[0] = 0
    bits[1] = 3
    tok_w = rng.integers(-3, 9, (N, Tm, 6))
    phi = rng.integers(-2, 9, (N, Ein, NI))
    psi = rng.integers(-3, 8, (N, Ein, NV))
    valid = rng.random((N, Ein)) < 0.7
    steps = np.zeros((N, L, 8), np.int64)
    steps[..., 0] = rng.integers(0, 6, (N, L))
    steps[..., 1] = rng.integers(-NV - 3, NV + 3, (N, L))
    steps[..., 2] = rng.integers(-NV - 3, NV + 3, (N, L))
    steps[..., 3] = rng.integers(-1, 4, (N, L))
    steps[..., 4] = rng.integers(0, 2, (N, L))
    steps[..., 5] = rng.integers(-NI - 2, NI + 2, (N, L))
    steps[..., 6] = rng.integers(0, 2, (N, L))
    steps[..., 7] = rng.integers(0, 12, (N, L))
    ct_sel = rng.integers(0, 2 * Tm + 1, N)
    cell_b = rng.integers(0, 4, N)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
            device=device, dtype=torch.int32)
         for k, v in dict(bits=bits, tok_w=tok_w, phi=phi, psi=psi,
                          steps=steps, ct_sel=ct_sel,
                          cell_b=cell_b).items()}
    ranges = _step_ranges(t["cell_b"], t["steps"], n_seq=4, n_keys=12,
                          ni=NI, nv=NV)
    k = 1
    args = (t["bits"], t["tok_w"], t["phi"], t["psi"],
            torch.from_numpy(valid).to(device), t["steps"][:, k],
            t["ct_sel"], ranges[4][:, k], ranges[5][:, k])
    return args, dict(emax=emax, tmax=Tm)
