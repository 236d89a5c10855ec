"""The match_count CUDA kernel on the card, bit-equal to its plain
PyTorch version.  Imports torch and the port only, so it runs on a
machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_match_count_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.match_count import ops
from scan_inputs import SHAPES, scan_inputs


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA branch: the kernel on the card is bit-equal to the plain
    version, and each call counts one launch."""
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 device")
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
