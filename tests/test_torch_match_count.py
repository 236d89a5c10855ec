"""match_count port vs the JAX package: the plain PyTorch version in its
per-row and scalar forms, bit-equal to the jnp reference and to the
Pallas kernel run in interpret mode, on inputs made with numpy from a
seed.  The CUDA kernel itself is tested on an sm_90 device by
test_torch_match_count_cuda.py."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from conftest import random_db
from repro.kernels.match_count.ops import (
    match_signatures_kernel as pallas_match_signatures,
)
from repro.mining.encoding import (
    encode_db,
    encode_embeddings,
    encode_pattern_trs,
)
from repro.mining.engine import (
    match_signatures as jax_scalar_ref,
    match_signatures_batch as jax_batch_ref,
)
from repro_torch.kernels.match_count import ops, ref
from scan_inputs import SHAPES, scan_inputs

def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("E,T", SHAPES)
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_per_row_plain_matches_jax(E, T, mode):
    """The per-row form (ops on CPU tensors runs the plain version) is
    bit-equal to repro.mining.engine.match_signatures_batch (the jit of
    match_signatures_batch_ref)."""
    rng = np.random.default_rng(E * 1000 + T + mode)
    G, NI, NV, P, NP = 4, 8, 8, 16, 5
    (tokens, gid, phi, psi, valid, pid, ex_stack, nv_stack,
     npat_stack) = scan_inputs(rng, E, G, T, NI, NV, P, NP)
    mode_stack = np.full((NP,), mode, np.int32)
    mode_stack[::2] = rng.integers(0, 4, (NP + 1) // 2)  # mixed phases
    args = (tokens, gid, phi, psi, valid, pid, ex_stack, nv_stack,
            npat_stack, mode_stack)
    want = np.asarray(jax_batch_ref(*[jnp.asarray(a) for a in args]))
    got = ops.match_signatures_batch(*_torch(*args))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if E * T > 100:
        assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("E,T", SHAPES)
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_scalar_plain_matches_pallas(E, T, mode):
    """The scalar form (ref.match_signatures_ref, and ops'
    match_signatures_kernel on CPU tensors, which runs the per-row
    version with one pattern) is bit-equal to the jnp reference and to
    the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(E * 1000 + T + mode + 7)
    (tokens, gid, phi, psi, valid, _, ex_stack, _,
     _) = scan_inputs(rng, E, 4, T, 8, 8, 16, 1)
    existing = ex_stack[0]
    nv, n_pat = 3, 2
    jargs = [jnp.asarray(a) for a in (tokens, gid, phi, psi, valid,
                                      existing)]
    scal = [jnp.int32(nv), jnp.int32(n_pat), jnp.int32(mode)]
    want = np.asarray(jax_scalar_ref(*jargs, *scal))
    pallas = np.asarray(pallas_match_signatures(*jargs, *scal,
                                                interpret=True))
    np.testing.assert_array_equal(pallas, want)
    targs = _torch(tokens, gid, phi, psi, valid, existing)
    plain = ref.match_signatures_ref(*targs, nv, n_pat, mode)
    wrapped = ops.match_signatures_kernel(*targs, nv, n_pat, mode)
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(wrapped.numpy(), want)


def test_plain_on_real_mining_scan():
    """Both forms on a scan the real miner issues (the root scan of an
    encoded random DB, as the JAX kernel test does)."""
    db = random_db(13, n_seq=8, n_steps=5, n_v=5)
    tdb = encode_db(db)
    embs = [(g, (), ()) for g in range(len(db))]
    gid, phi, psi = encode_embeddings(embs, 16, 12)
    valid = np.ones((len(embs),), np.int32)
    existing = encode_pattern_trs((), 64)
    jargs = [jnp.asarray(x) for x in (tdb.tokens, gid, phi, psi, valid,
                                      existing)]
    targs = _torch(tdb.tokens, gid, phi, psi, valid, existing)
    for mode in (0, 3):
        want = np.asarray(jax_scalar_ref(*jargs, jnp.int32(0),
                                         jnp.int32(0), jnp.int32(mode)))
        assert (want >= 0).any()  # non-trivial scan
        got = ops.match_signatures_kernel(*targs, 0, 0, mode)
        np.testing.assert_array_equal(got.numpy(), want)
        pid = np.zeros(len(embs), np.int32)
        per_row = ops.match_signatures_batch(
            *_torch(tdb.tokens, gid, phi, psi, valid, pid, existing[None],
                    np.zeros(1, np.int32), np.zeros(1, np.int32),
                    np.full(1, mode, np.int32)))
        np.testing.assert_array_equal(per_row.numpy(), want)


def test_cpu_tensors_never_launch():
    """CPU tensors take the plain version and leave the launch count
    alone; a wrong dtype raises instead of being converted."""
    rng = np.random.default_rng(3)
    arrays = scan_inputs(rng, 9, 3, 5, 4, 4, 8, 2)
    before = ops.launches
    ops.match_signatures_batch(*_torch(*arrays, np.zeros(2, np.int32)))
    assert ops.launches == before
    bad = _torch(*arrays, np.zeros(2, np.int32))
    bad[0] = bad[0].long()
    with pytest.raises(TypeError):
        ops.match_signatures_batch(*bad)
