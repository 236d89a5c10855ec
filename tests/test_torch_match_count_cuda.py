"""The match_count CUDA kernel on the card, bit-equal to its plain
PyTorch version.  Imports torch and the port only, so it runs on a
machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_match_count_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.match_count import ops, ref
from scan_inputs import PIDS, SHAPES, TABLES, WIDTHS, scan_inputs

# the kernel's edge sweep: rows per block of 1 to 32, a block of one
# row wider than 256 threads, and a ragged last block
EDGE_E = (1, 5, 37, 129, 1024)
EDGE_T = (1, 31, 32, 33, 64, 300)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _need_card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 device")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA branch: the kernel on the card is bit-equal to the plain
    version, and each call counts one launch."""
    _need_card()
    rng = np.random.default_rng(11)
    for E, T in SHAPES:
        arrays = scan_inputs(rng, E, 4, T, 16, 12, 64, 7)
        mode_stack = rng.integers(0, 4, (7,)).astype(np.int32)
        cpu = _torch(*arrays, mode_stack)
        want = ops.match_signatures_batch(*cpu)
        before = ops.launches
        got = ops.match_signatures_batch(*[x.cuda() for x in cpu])
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("tables", TABLES)
def test_cuda_kernel_edge_tables(tables):
    """Both forms of the kernel, bit-equal to the plain version on the
    card, on each existing-table kind of scan_inputs at the main path's
    widths (NI 16, NV 12, P 64) over EDGE_E x EDGE_T, the pid layouts
    taken in turn."""
    _need_card()
    rng = np.random.default_rng(TABLES.index(tables))
    dev = torch.device("cuda")
    for i, (E, T) in enumerate((E, T) for E in EDGE_E for T in EDGE_T):
        pids = PIDS[i % len(PIDS)]
        NP = 1 if pids == "one" else 64
        arrays = scan_inputs(rng, E, 40, T, 16, 12, 64, NP, tables=tables,
                             pids=pids)
        mode_stack = rng.integers(0, 4, (NP,)).astype(np.int32)
        args = [x.to(dev) for x in _torch(*arrays, mode_stack)]
        got = ops.match_signatures_batch(*args)
        want = ref.match_signatures_batch_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (tables, pids, E, T)
        tokens, gid, phi, psi, valid, _, ex_stack = args[:7]
        scal = (int(arrays[7][0]), int(arrays[8][0]), int(mode_stack[0]))
        got = ops.match_signatures_kernel(tokens, gid, phi, psi, valid,
                                          ex_stack[0], *scal)
        want = ref.match_signatures_ref(tokens, gid, phi, psi, valid,
                                        ex_stack[0], *scal)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ("scalar", tables, E, T)


# (E, T) of the cases at other widths
OTHER_SHAPES = [(1, 1), (37, 33), (129, 31), (5, 300)]


@pytest.mark.cuda
@pytest.mark.parametrize("NI,NV,P", WIDTHS)
def test_cuda_kernel_other_widths(NI, NV, P):
    """Both forms of the kernel, bit-equal to the plain version on the
    card, at widths other than the main path's, on every existing-table
    kind of scan_inputs, the pid layouts taken in turn."""
    _need_card()
    rng = np.random.default_rng(100 + NI * 31 + NV + P)
    dev = torch.device("cuda")
    cases = [(t, E, T) for t in TABLES for E, T in OTHER_SHAPES]
    for i, (tables, E, T) in enumerate(cases):
        pids = PIDS[i % len(PIDS)]
        NP = 1 if pids == "one" else 9
        arrays = scan_inputs(rng, E, 40, T, NI, NV, P, NP, tables=tables,
                             pids=pids)
        mode_stack = rng.integers(0, 4, (NP,)).astype(np.int32)
        args = [x.to(dev) for x in _torch(*arrays, mode_stack)]
        got = ops.match_signatures_batch(*args)
        want = ref.match_signatures_batch_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (NI, NV, P, tables, pids, E, T)
        tokens, gid, phi, psi, valid, _, ex_stack = args[:7]
        scal = (int(arrays[7][0]), int(arrays[8][0]), int(mode_stack[0]))
        got = ops.match_signatures_kernel(tokens, gid, phi, psi, valid,
                                          ex_stack[0], *scal)
        want = ref.match_signatures_ref(tokens, gid, phi, psi, valid,
                                        ex_stack[0], *scal)
        torch.cuda.synchronize()
        assert torch.equal(got, want), ("scalar", NI, NV, P, tables, E, T)
