"""The join step's compaction (``kernels.step_compact``): the plain
version bit-equal to the epilogue that ``serving.batch._step_once`` ran
inline before it had a kernel (frozen below), and on the card the CUDA
kernel bit-equal to the plain version, and the serving path giving the
host oracle's rows with one compaction launch per predicate call.
Imports torch and the port only; the card's tests run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_step_compact.py
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core.compile import compile_sequence
from repro_torch.core.containment import contains
from repro_torch.data.synthetic import random_graph_sequence
from repro_torch.kernels import INT32_MIN, gather_cell_rows
from repro_torch.kernels.step_compact import ops
from repro_torch.kernels.step_compact.ref import step_compact_core
from repro_torch.mining.driver import AcceleratedMiner
from repro_torch.serving import batch
from repro_torch.serving.bank import compile_bank
from repro_torch.serving.server import PatternServer
from compact_inputs import MODES, N_CELLS, NI, NV, SHAPES, \
    compact_inputs, mode_kw

_I32 = torch.int32


def _parent_epilogue(bits, tok_w, phi, psi, valid, step_k, ct_sel, pu_c,
                     pu_ok, *, emax, tmax, compact, count_frontier_ovf):
    """``_step_once``'s code after the predicate as it stood before the
    kernel, frozen: the plain version must not drift from it."""
    N, Ein, NI = phi.shape
    NV = psi.shape[2]
    E, Tm = emax, tmax
    C = Ein * Tm * 2
    dev = phi.device
    nv_ids = torch.arange(NV, dtype=_I32, device=dev)
    ni_ids = torch.arange(NI, dtype=_I32, device=dev)
    cand_ids = torch.arange(C, dtype=_I32, device=dev)
    ty_s, pu1_s, pu2_s, lab_s, new_s, idx_s, sval_s, key_s = (
        step_k[:, c] for c in range(8))
    flags = (torch.stack([bits & 1, (bits >> 1) & 1], -1) > 0).reshape(N, C)
    window_ovf = (ct_sel > Tm) & valid.any(-1)
    if not compact:
        if count_frontier_ovf:
            frontier_ovf = flags.sum(-1) > E
            return flags.any(-1), window_ovf | frontier_ovf
        return flags.any(-1), window_ovf
    cand_row = cand_ids[None, :]
    sels = []
    last = torch.full((N, 1), -1, dtype=_I32, device=dev)
    for _ in range(E):
        cur = torch.where(flags & (cand_row > last), cand_row, C).amin(
            -1, keepdim=True)
        sels.append(cur)
        last = cur
    frontier_ovf = torch.where(
        flags & (cand_row > last), cand_row, C).amin(-1) < C
    sel = torch.cat(sels, -1)
    new_valid = sel < C
    sel = torch.clamp(sel, max=C - 1)
    e_old = sel // (Tm * 2)
    t_w = (sel // 2) % Tm
    var = sel % 2
    phi_src = gather_cell_rows(phi, e_old)
    psi_src = gather_cell_rows(psi, e_old)

    def wfield(f):
        return torch.gather(tok_w[..., f], 1, t_w.long())

    u1_g, u2_g, j_g = wfield(1), wfield(2), wfield(4)
    claim = (new_s[:, None] > 0) & new_valid
    onehot_ni = ni_ids[None, None, :] == idx_s[:, None, None]
    phi_new = torch.where(onehot_ni & claim[..., None], j_g[..., None],
                          phi_src)
    a_g = torch.where(var == 0, u1_g, u2_g)
    b_g = torch.where(var == 0, u2_g, u1_g)
    is_v = (ty_s <= 2)[:, None]
    fresh = torch.where(
        pu_ok[:, None, :],
        torch.gather(psi_src, 2, pu_c[:, None, :].expand(N, E, 2)),
        INT32_MIN) < 0
    fresh1, fresh2 = fresh[..., 0], fresh[..., 1]
    onehot1 = nv_ids[None, None, :] == pu1_s[:, None, None]
    onehot2 = nv_ids[None, None, :] == pu2_s[:, None, None]
    assign1 = torch.where(is_v, u1_g, a_g)
    psi_new = torch.where(onehot1 & (fresh1 & new_valid)[..., None],
                          assign1[..., None], psi_src)
    psi_new = torch.where(
        onehot2 & ((~is_v) & fresh2 & new_valid)[..., None],
        b_g[..., None], psi_new)
    return phi_new, psi_new, new_valid, frontier_ovf | window_ovf


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.cpu().numpy(), w.cpu().numpy())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("emax,Ein,Tm", SHAPES)
def test_plain_matches_parent_epilogue(emax, Ein, Tm, mode):
    """Every output of the plain version, rows past ``new_valid``
    included, equals the frozen inline epilogue's; the inputs reach
    every branch: more than emax accepted, none, window overflow."""
    args, kw = compact_inputs(emax * 1000 + Ein * 10 + Tm, N_CELLS, emax,
                              Ein, Tm)
    kw.update(mode_kw(mode))
    before = ops.launches
    got = ops.step_compact(*args, **kw)
    assert ops.launches == before  # the plain version never counts
    _assert_same(got, _parent_epilogue(*args, **kw))
    _assert_same(got, step_compact_core(*args, **kw))
    flags = ((args[0] & 1) + ((args[0] >> 1) & 1)).sum((1, 2))
    assert flags[0] == 0 and (flags > emax).any()
    if mode == "compact":
        phi_new, psi_new, new_valid, ovf = got
        assert not new_valid[0].any() and new_valid[1].all()
        # an empty slot copies frontier row Ein - 1, no update
        assert torch.equal(phi_new[0], args[2][0, -1:].expand(emax, NI))
        assert torch.equal(psi_new[0], args[3][0, -1:].expand(emax, NV))
        assert (ovf == (flags > emax) | ((args[6] > Tm)
                                         & args[4].any(-1))).all()
    else:
        acc, ovf = got
        assert torch.equal(acc, flags > 0)
        assert ovf.any()


def test_wrapper_checks_inputs():
    args, kw = compact_inputs(0, 9, 4, 4, 8)
    kw.update(mode_kw("compact"))
    bits, tok_w, phi, psi, valid, step_k, ct_sel, pu_c, pu_ok = args
    with pytest.raises(TypeError):
        ops.step_compact(bits.long(), *args[1:], **kw)
    with pytest.raises(TypeError, match="valid"):
        ops.step_compact(*args[:4], valid.to(_I32), *args[5:], **kw)
    with pytest.raises(ValueError, match="expected"):
        ops.step_compact(*args, **dict(kw, tmax=7))
    with pytest.raises(ValueError, match="expected"):
        ops.step_compact(bits, tok_w[:, :4].contiguous(), *args[2:], **kw)
    with pytest.raises(ValueError, match="emax"):
        ops.step_compact(*args, **dict(kw, emax=0))


# ------------------------------------------------------------- on the card


def _needs_card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 device")


def _kernel_equal(seed, N, emax, Ein, Tm, modes=MODES, p_match=0.2):
    """The kernel (one launch a call) against the plain version on the
    same values, its step rows and ``pu_c`` / ``pu_ok`` strided views of
    tables built on the card."""
    cpu, kw = compact_inputs(seed, N, emax, Ein, Tm, p_match)
    dev, _ = compact_inputs(seed, N, emax, Ein, Tm, p_match, "cuda")
    assert dev[5].stride(0) == 8 * 3 and dev[7].stride(0) == 6 * 3
    for mode in modes:
        mkw = dict(kw, **mode_kw(mode))
        want = ops.step_compact(*cpu, **mkw)
        before = ops.launches
        got = ops.step_compact(*dev, **mkw)
        torch.cuda.synchronize()
        assert ops.launches == before + 1
        _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("emax,Ein,Tm", SHAPES)
def test_kernel_matches_plain(emax, Ein, Tm, mode):
    _needs_card()
    _kernel_equal(emax * 1000 + Ein * 10 + Tm, N_CELLS, emax, Ein, Tm,
                  modes=(mode,))


@pytest.mark.cuda
@pytest.mark.parametrize("N,emax,Ein,Tm", [
    (32768, 4, 1, 8), (32768, 4, 4, 8),  # a flat first pass, emax 4
    (1024, 16, 1, 8), (1024, 16, 16, 8),  # a replay step, emax 16
    (4096, 16, 16, 32)])
def test_kernel_matches_plain_at_serving_shapes(N, emax, Ein, Tm):
    _needs_card()
    _kernel_equal(N + Tm, N, emax, Ein, Tm, p_match=0.05)


@pytest.mark.cuda
def test_kernel_refuses_an_emax_past_shared_memory():
    """The kept candidates of a block's cells live in 48 KB of shared
    memory: an emax past that raises without a launch, and the next call
    is not charged with its error."""
    _needs_card()
    args, kw = compact_inputs(3, 5, 4, 1, 2, device="cuda")
    before = ops.launches
    with pytest.raises(RuntimeError, match="emax=4000"):
        ops.step_compact(*args, **dict(kw, emax=4000, compact=True))
    assert ops.launches == before
    ops.step_compact(*args, **dict(kw, compact=True))
    torch.cuda.synchronize()
    assert ops.launches == before + 1


def _db(seed, n_seq, n_steps, n_v):
    rng = random.Random(seed)
    return [compile_sequence(random_graph_sequence(
        rng, n_steps=n_steps, n_v=n_v, n_vl=2, n_el=2))
        for _ in range(n_seq)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["flat", "trie", "trie_fused"])
def test_server_batch_on_cuda_equals_oracle(layout):
    """One batch of each layout on the card, at the default frontier and
    at one that escalates (so that ``trie_fused`` steps too): the rows
    equal the host oracle, and every predicate call was followed by one
    compaction launch."""
    _needs_card()
    db, queries = _db(11, 10, 5, 5), _db(12, 24, 6, 5)
    bank = compile_bank(AcceleratedMiner(db, device="cuda").mine_rs(
        2, max_len=5))
    want = np.array([[contains(p, s) for p in bank.patterns]
                     for s in queries])
    for emax, retry in ((4, 16), (1, 2)):
        ops.launches = batch.predicate_calls = 0
        srv = PatternServer(bank, device="cuda", emax=emax,
                            emax_retry=retry, max_batch=len(queries),
                            bank_layout=layout)
        got = np.stack([r.contained for r in srv.query(queries)])
        np.testing.assert_array_equal(got, want)
        assert ops.launches == batch.predicate_calls
        if layout != "trie_fused" or emax == 1:
            assert ops.launches > 0
