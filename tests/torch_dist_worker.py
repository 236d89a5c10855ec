"""A world of ``torch.distributed`` ranks for the port's multi-rank
tests and ``chip_smoke.py``: ``run_world`` spawns the ranks (``spawn``
start method), each joins one process group through a ``file://``
store under the caller's directory (no TCP port, so parallel test
workers never collide), runs one job and saves what it returns for the
caller.  The tests' jobs live in this importable module because spawn
sends a function by reference.  Imports torch and the port only."""
from __future__ import annotations

import os
import pickle
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def mining_job(inputs: str, cases, device: str) -> dict:
    """The port's mining step on every case ``(mesh, db_axes, prededup,
    k, scan)``: ``mesh`` "host" is ``make_host_mesh(model=2)``, "2x2x2"
    a ("pod","data","model") mesh; ``scan`` names the arrays of
    ``inputs`` (``<scan>_gid`` ...).  Also whether the meshes the world
    cannot hold are refused."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels.match_count import ops
    from repro_torch.collectives import axes_group, rank_device
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.mining.distributed import make_mining_step

    arrays = np.load(inputs)
    meshes = {"host": make_host_mesh(model=2, device=device)}
    dev = rank_device(meshes["host"])
    if dist.get_world_size() == 8:
        meshes["2x2x2"] = init_device_mesh(
            device, (2, 2, 2), mesh_dim_names=("pod", "data", "model"))

    def t(name):
        return torch.from_numpy(arrays[name]).to(dev)

    out = {}
    launches0 = ops.launches
    for i, (mesh, db_axes, prededup, k, scan) in enumerate(cases):
        step = make_mining_step(meshes[mesh], k=k, db_axes=db_axes,
                                tok_axis="model", prededup=prededup)
        uniq, counts, n_distinct = step(
            t("tokens"), t(f"{scan}_gid"), t(f"{scan}_phi"),
            t(f"{scan}_psi"), t(f"{scan}_valid"), t(f"{scan}_existing"),
            int(arrays[f"{scan}_nv"]), int(arrays[f"{scan}_n_pat"]),
            int(arrays[f"{scan}_mode"]))
        out[f"{i}_uniq"] = uniq.cpu().numpy()
        out[f"{i}_counts"] = counts.cpu().numpy()
        out[f"{i}_n_distinct"] = n_distinct.cpu().numpy()
    out["launches"] = np.int64(ops.launches - launches0)
    if "2x2x2" in meshes:  # the steps built on it made its group
        group = axes_group(meshes["2x2x2"], ("pod", "data"))
        out["db_group_kept"] = np.array([
            group is axes_group(meshes["2x2x2"], ("pod", "data")),
            dist.get_world_size(group) == 4])
    out["refused"] = np.array([_refuses(make_host_mesh, model=3,
                                        device=device),
                               _refuses(make_production_mesh,
                                        device=device),
                               _refuses(make_production_mesh,
                                        multi_pod=True, device=device)])
    return out


def _refuses(make, **kw) -> bool:
    """Whether building a mesh the world cannot hold raises."""
    try:
        make(**kw)
    except ValueError:
        return True
    return False


def serving_job(inputs: str, cases, device: str) -> dict:
    """The port's sharded serving steps on a data x model mesh of
    ``model=2``: each case ``(layout, emax)`` runs the flat step on
    ``tokens``/``steps``/``pattern_valid`` or the trie step on the
    ``lvl_*``/``term_*``/``trie_valid`` stack of ``inputs``."""
    from repro_torch.kernels.containment import ops
    from repro_torch.collectives import rank_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serving import batch
    from repro_torch.serving.sharded import make_serving_step, \
        make_trie_serving_step

    arrays = np.load(inputs)
    mesh = make_host_mesh(model=2, device=device)
    dev = rank_device(mesh)
    kw = dict(nv=int(arrays["nv"]), n_label_keys=int(arrays["n_label_keys"]),
              tmax=int(arrays["tmax"]))

    def t(name):
        return torch.from_numpy(arrays[name]).to(dev)

    out = {}
    launches0, calls0 = ops.launches, batch.predicate_calls
    for i, (layout, emax) in enumerate(cases):
        if layout == "flat":
            step = make_serving_step(mesh, emax=emax, **kw)
            c, o = step(t("tokens"), t("steps"), t("pattern_valid"))
        else:
            step = make_trie_serving_step(mesh, emax=emax, **kw)
            c, o = step(t("tokens"), t("lvl_steps"), t("lvl_parent_pos"),
                        t("term_level"), t("term_pos"), t("trie_valid"))
        out[f"{i}_contained"] = c.cpu().numpy()
        out[f"{i}_overflow"] = o.cpu().numpy()
    out["launches"] = np.int64(ops.launches - launches0)
    out["predicate_calls"] = np.int64(batch.predicate_calls - calls0)
    return out


def recsys_serve_job(inputs, cfg_kw: dict, model: int, device: str,
                     repeats: int = 0) -> dict:
    """The port's vocab-sharded BERT4Rec serve on a data x ``model``
    mesh: every rank passes the global params and ``seq`` and returns its
    block.  ``inputs`` is an npz of the params by path and ``seq``, or
    None: the params drawn on the CPU from seed 0 and ``seq`` from
    numpy's seed 0 (``b4r_inputs``).  With ``repeats`` the ms of each
    of that many calls, synchronized.  Also the arch's serve step over
    the mesh at batch 1 (``serve_scores``) and at batch 512."""
    from repro_torch.collectives import axes_index, rank_device
    from repro_torch.configs.families import RecsysArch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import bert4rec as b4r
    from repro_torch.models.common import dp_axes

    cfg = b4r.Bert4RecConfig(**cfg_kw)
    mesh = make_host_mesh(model=model, device=device)
    dev = rank_device(mesh)
    params, seq = b4r_inputs(cfg, inputs, dev)
    serve = b4r.make_sharded_serve(cfg, mesh, dp_axes(mesh))
    with torch.no_grad():
        s, i = serve(params, {"seq": seq})
        ms = []
        for _ in range(repeats):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            serve(params, {"seq": seq})
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
        arch = RecsysArch(cfg, cfg)
        one, _ = arch.make_serve_step("retrieval_cand", mesh)
        s1, i1 = one(params, {"seq": seq[:1]})
        r1 = b4r.serve_scores(params, {"seq": seq[:1]}, cfg)
        many, _ = arch.make_serve_step("serve_p99", mesh)
    row, n_rows = axes_index(mesh, dp_axes(mesh))
    return {"scores": s.cpu().numpy(), "ids": i.cpu().numpy(),
            "row": np.int64(row), "n_rows": np.int64(n_rows),
            "model": np.int64(axes_index(mesh, ("model",))[0]),
            "ms": np.array(ms),
            "one_scores": s1.cpu().numpy(), "one_ids": i1.cpu().numpy(),
            "ref_scores": r1[0].cpu().numpy(), "ref_ids": r1[1].cpu().numpy(),
            "one_global": np.bool_(getattr(one, "takes_global", False)),
            "many_global": np.bool_(getattr(many, "takes_global", False))}


def b4r_inputs(cfg, inputs, device, batch: int = 512):
    """(params, seq) for ``recsys_serve_job`` on ``device``: from the npz
    ``inputs`` (params by path, "seq"), or drawn from seed 0 with
    ``batch`` sessions of random length."""
    from repro_torch.models import bert4rec as b4r
    from repro_torch.models.common import path_str, tree_leaves_with_path, \
        tree_unflatten

    if inputs is None:
        params = b4r.init_params(torch.Generator().manual_seed(0), cfg,
                                 torch.device("cpu"))
        rng = np.random.default_rng(0)
        seq = rng.integers(1, cfg.n_items + 1, (batch, cfg.seq_len))
        seq[np.arange(cfg.seq_len) >= rng.integers(
            1, cfg.seq_len + 1, batch)[:, None]] = 0
        seq = torch.as_tensor(seq.astype(np.int32))
    else:
        arrays = np.load(inputs)
        shape = b4r.abstract_params(cfg)
        params = tree_unflatten(shape, [
            torch.from_numpy(arrays[path_str(p)])
            for p, _ in tree_leaves_with_path(shape)])
        seq = torch.from_numpy(arrays["seq"])
    params = {k: ({kk: vv.to(device) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}
    return params, seq.to(device)


def _rank_main(rank, world, backend, store, out_dir, job, args):
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        out = job(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(job, world: int, workdir: str, *args, backend: str = "gloo",
              timeout: float = 300.0) -> list:
    """Run ``job(*args)`` on ``world`` spawned ranks of one process group
    (``backend``) and return what each rank's call returned, in rank
    order.  ``job`` must be importable by reference (a module-level
    function).  Raises with the rank's traceback when a rank fails, and
    stops every rank when the world outlasts ``timeout`` seconds."""
    store = os.path.join(workdir, f"{job.__name__}_store")
    out_dir = os.path.join(workdir, f"{job.__name__}_out")
    os.makedirs(out_dir, exist_ok=True)
    for path in [store] + [os.path.join(out_dir, f"rank{r}.pkl")
                           for r in range(world)]:
        if os.path.exists(path):  # a stale store would hang the world
            os.unlink(path)
    ctx = mp.start_processes(
        _rank_main, args=(world, backend, store, out_dir, job, args),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{job.__name__}: the world of {world} "
                                   f"ranks outlasted {timeout}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
