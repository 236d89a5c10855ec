"""The containment-step port vs the JAX package: the plain PyTorch
version (the wrapper on CPU tensors) bit-equal to the jnp reference and
to the Pallas kernel in interpret mode, on inputs made with numpy from a
seed; and the kernel build's cache key.  The CUDA kernel itself is
tested on an sm_90 device by test_torch_serving_cuda.py."""
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro.kernels.containment.containment import contain_step_blocked
from repro.kernels.containment.ref import contain_step_core as jax_core
from repro_torch.kernels import _build
from repro_torch.kernels.containment import ops, ref
from contain_inputs import SHAPES, contain_inputs


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("G,E,Tm", SHAPES)
def test_plain_matches_jax(G, E, Tm):
    """ops.contain_step on CPU tensors (the plain version) is bit-equal
    to repro.kernels.containment.ref.contain_step_core, root steps
    (Ein = 1) included."""
    rng = np.random.default_rng(G * 100 + E + Tm)
    args = contain_inputs(rng, G, E, Tm)
    want = np.asarray(jax_core(*[jnp.asarray(a) for a in args]))
    got = ops.contain_step(*_torch(*args))
    assert got.dtype == torch.int32 and got.shape == (G, E, Tm)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(ref.contain_step_core(*_torch(*args)),
                                  want)
    if G * E * Tm > 2000:
        assert (want & 1).any()


def test_plain_matches_pallas_interpret():
    """The Pallas kernel run in interpret mode gives the same masks."""
    rng = np.random.default_rng(5)
    args = contain_inputs(rng, 40, 4, 16)
    want = np.asarray(contain_step_blocked(
        *[jnp.asarray(a) for a in args], block_g=16, interpret=True))
    np.testing.assert_array_equal(ops.contain_step(*_torch(*args)).numpy(),
                                  want)


def test_wrapper_checks_inputs():
    tok, psi, srow = _torch(*contain_inputs(np.random.default_rng(1),
                                            4, 2, 3))
    with pytest.raises(TypeError):
        ops.contain_step(tok.long(), psi, srow)
    with pytest.raises(ValueError):
        ops.contain_step(tok, psi[:, :1], srow)
    before = ops.launches
    ops.contain_step(tok, psi, srow)
    assert ops.launches == before  # the plain version never counts


def test_library_path_hashes_shared_headers(tmp_path, monkeypatch):
    """An edited shared header gives every kernel a new library name, so
    a stale build is never loaded; the source itself still counts."""
    for f in os.listdir(_build.CSRC):
        (tmp_path / f).write_bytes((_build.CSRC / f).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build.library_path(n) for n in ("containment",
                                                  "trie_walk")}
    assert before == {n: _build.library_path(n) for n in before}
    hdr = tmp_path / "contain_pred.cuh"
    hdr.write_bytes(hdr.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    src = tmp_path / "containment.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build.library_path("containment") != after["containment"]
    assert _build.library_path("trie_walk") == after["trie_walk"]


def test_build_includes_csrc(tmp_path, monkeypatch):
    """nvcc is given the source directory as an include path."""
    calls = []

    class Done:
        returncode = 0
        stdout = stderr = ""

    def fake_run(cmd, **kw):
        calls.append(cmd)
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return Done()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    out = _build.build("trie_walk")
    assert out.exists() and len(calls) == 1
    cmd = calls[0]
    assert cmd[cmd.index("-I") + 1] == str(_build.CSRC)
    assert cmd[-1].endswith("trie_walk.cu")
    assert _build.build("trie_walk") == out and len(calls) == 1
