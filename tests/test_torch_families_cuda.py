"""The GNN, MACE and BERT4Rec families on the card: the five smoke steps on
cuda held to the same steps on the CPU, MACE's rotation invariance, the
chunked top-k against brute force, and the recsys integration path
(mine, serve under every layout, EmbeddingBag, chunked top-k) on cuda
against the CPU.  Imports torch and the port only, so it runs on a
machine with the card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_families_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.data.graphs import random_molecule_batch
from repro_torch.models import bert4rec as b4r
from repro_torch.models import mace
from repro_torch.models.common import tree_map
import torch_family_checks as fc


def _needs_card():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs an sm_90 device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", fc.FAMILY_IDS)
def test_family_smoke_cuda_vs_cpu(arch_id):
    _needs_card()
    errs = fc.family_smoke_vs_cpu(arch_id)
    assert np.isfinite(errs["loss_cuda"])


@pytest.mark.cuda
def test_mace_rotation_invariance_cuda():
    _needs_card()
    cfg = mace.MACEConfig(name="mace", n_layers=2, d_hidden=32)
    g = random_molecule_batch(np.random.default_rng(0), 4, 8, 16)
    batch = {k: torch.as_tensor(g[k], device="cuda") for k in
             ("species", "pos", "edges", "graph_id")}
    batch["n_graphs"] = 4
    params = mace.init_params(torch.Generator("cuda").manual_seed(0), cfg)
    fc.rotation_invariance(lambda p, b: mace.forward(p, b, cfg), params,
                           batch)


@pytest.mark.cuda
def test_integration_path_cuda_vs_cpu():
    """The example's chain at its demo config on cuda under all three
    layouts, against the same chain on the CPU from the same weights:
    the feature matrix and the top-k ids equal, the scores within
    1e-5; the ids also held to brute force."""
    _needs_card()
    cfg = b4r.Bert4RecConfig(name="demo", **fc.DEMO)
    gen = torch.Generator().manual_seed(0)
    params = b4r.init_params(gen, cfg)
    table = torch.randn(fc.TOP, cfg.d_model, generator=gen) * 0.1
    on_card = tree_map(lambda x: x.cuda(), params)
    got = fc.recsys_integration(on_card, table.cuda(), cfg, "cuda",
                                layouts=("flat", "trie", "trie_fused"))
    want = fc.recsys_integration(params, table, cfg, "cpu")
    np.testing.assert_array_equal(got["feats"], want["feats"])
    np.testing.assert_array_equal(got["ids"].cpu().numpy(),
                                  want["ids"].numpy())
    np.testing.assert_allclose(got["scores"].cpu().numpy(),
                               want["scores"].numpy(), rtol=1e-5,
                               atol=1e-5)
    fc.topk_vs_bruteforce(on_card["item_emb"], got["query"], got["ids"],
                          cfg)
