"""Dry run of every (arch x shape x mesh) cell: one rank's program traced
on a fake world of 256 ranks (16x16 ``("data", "model")``) or 512
(2x16x16 with ``"pod"``), computing nothing and taking no memory.

    python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out DIR] [--skip-existing]
        [--device cpu]

Where the JAX package lowers and compiles each cell for 512 fake host
devices and reads XLA's analyses, a cell here is:

* a fake process group (``torch.testing``'s ``FakeStore`` and the
  "fake" backend): rank 0 of the world, whose collectives return at
  once; the production mesh over it (``launch.mesh``), on ``cuda``
  unless ``--device cpu`` is given;
* ``FakeTensorMode``: every tensor is a shape, a dtype and a device;
* the step: the mining step and the vocab-sharded BERT4Rec serve are
  written per rank (handed the global tensors, each rank cuts its
  blocks, as ``shard_map`` does) and run as they are; every other step
  is handed DTensors placed by ``arch.arg_specs`` and DTensor partitions
  it, as GSPMD partitions the JAX program;
* ``_Counter``: rank 0's local ops, counted - FLOPs (``torch.utils.
  flop_counter``'s registry), the bytes each op reads and writes, the
  collectives by kind (``roofline.analysis``), the peak of live bytes,
  and the calls of the port's custom kernel ops by name.

Each cell writes ``{arch}__{shape}__{single|multi}.json`` with the JAX
module's keys where the quantity exists: ``memory`` (``argument_size_
in_bytes`` - the rank's blocks of the arguments the step reads, as
``jax.jit`` drops unused ones; ``output_size_in_bytes``;
``temp_size_in_bytes`` - the peak of live bytes above the arguments,
outputs live at the peak included; ``per_device_total_bytes`` -
arguments plus that peak), ``collectives``, ``roofline`` and
``t_trace_s``.  The bytes are eager, op by op.  A cell whose trace
raises is written ``ok: false`` with the error and traceback.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _leaves

from ..configs.registry import get_arch, list_archs
from ..kernels import DeviceLike
from ..models import common
from ..models.common import P
from ..roofline import analysis
from .mesh import make_production_mesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "build", "dryrun")
# DTensor runs an op once on the global shapes to learn its output's
# (sharding propagation); those runs are not the rank's work
_PROPAGATION = os.path.join("distributed", "tensor", "_sharding_prop.py")
# factories that write nothing
_NO_WRITE = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided"}


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """This process as rank 0 of a fake world of ``n_ranks``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _in_propagation() -> bool:
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """Whether the op returns a view of an input (not an in-place
    write): it moves no bytes."""
    rets = func._schema.returns
    return bool(rets) and rets[0].alias_info is not None and \
        not rets[0].alias_info.is_write


class _Counter(TorchDispatchMode):
    """Counts the local ops of a trace.  An op on DTensors is handed on
    to DTensor (``_via_dtensor``), whose local ops come back through the
    mode and are counted, or placed by hand where DTensor cannot
    partition it (``_by_hand``).  ``args`` are the argument tensors as
    the local ops see them; which of them any op reads is kept in
    ``read``, and their storages are not counted as live."""

    def __init__(self, args: List[torch.Tensor]):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, Dict[str, float]] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.fallbacks: Dict[str, int] = collections.Counter()
        self._deferred: list = []
        self._in_dtensor = 0  # DTensor dispatches under way
        self._args = {id(t) for t in args}
        self.read = set()
        self._arg_storages = {t.untyped_storage()._cdata for t in args}
        self._live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._arg_storages or key in self._live:
            return
        self._live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key)

    def _via_dtensor(self, func, args, kwargs):
        """``func`` on DTensor arguments, partitioned by DTensor, its
        local ops coming back through the mode."""
        self._deferred.append(func)
        self._in_dtensor += 1
        try:
            with self:
                return func(*args, **kwargs)
        finally:
            self._in_dtensor -= 1
            if self._deferred and self._deferred[-1] is func:
                self._deferred.pop()

    def _by_hand(self, func, args, kwargs):
        """``func`` where DTensor cannot partition it as placed (no
        strategy, or a layout it cannot reshape, such as heads that do
        not divide the model axis): first with every DTensor argument
        kept split only on its dim 0 (the batch), the rest gathered (and
        made contiguous for a view: DTensor may not view its local
        strides); else gathered whole and run replicated on every rank,
        the outputs replicated DTensors.  The collectives are counted,
        and each op so placed in ``fallbacks``."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        from torch.utils._pytree import tree_map

        name = str(func)
        mesh = next(a.device_mesh for a in _leaves((args, kwargs))
                    if isinstance(a, DTensor))
        whole = [Replicate()] * mesh.ndim

        def batch_only(a):
            if not isinstance(a, DTensor):
                return a
            a = a.redistribute(mesh, [
                p if p == Shard(0) else Replicate() for p in a.placements])
            return a.clone(memory_format=torch.contiguous_format) \
                if _is_view(func) else a

        try:
            with self:  # the redistributions' collectives are counted
                args_b = tree_map(batch_only, args)
                kwargs_b = tree_map(batch_only, kwargs)
            out = self._via_dtensor(func, args_b, kwargs_b)
            self.fallbacks[name + " (batch kept)"] += 1
            return out
        except Exception:  # noqa: BLE001 - DTensor's own errors vary
            pass
        self.fallbacks[name] += 1

        def gather(a):
            if isinstance(a, DTensor):
                return a.redistribute(mesh, whole).to_local()
            return a

        def wrap(t):
            if isinstance(t, torch.Tensor):
                return DTensor.from_local(t, mesh, whole, run_check=False)
            return t

        with self:
            out = func(*tree_map(gather, args), **tree_map(gather, kwargs))
        return tree_map(wrap, out)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._deferred and self._deferred[-1] is func:
                self._deferred.pop()
                return NotImplemented  # to DTensor, the mode still pushed
            try:
                return self._via_dtensor(func, args, kwargs)
            except Exception:  # noqa: BLE001 - DTensor's own errors vary
                return self._by_hand(func, args, kwargs)
        out = func(*args, **kwargs)
        if self._in_dtensor and _in_propagation():
            return out
        ins = [t for t in _leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
        self.read.update(id(t) for t in ins if id(t) in self._args)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        analysis.count_collective(self.collectives, func, out)
        if not _is_view(func):
            moved = sum(_nbytes(t) for t in ins)
            if func._opname not in _NO_WRITE:
                moved += sum(_nbytes(t) for t in outs)
            self.bytes += moved
            if func.namespace == "repro_torch":
                k = self.kernels.setdefault(
                    f"{func.namespace}::{func._opname}",
                    {"calls": 0, "bytes": 0})
                k["calls"] += 1
                k["bytes"] += moved
        for t in outs:
            self._track(t)
        return out


@functools.cache
def _register_strategies() -> None:
    """Sharding strategies for ops the models call: ``scatter_reduce``
    (``segment_max``), which DTensor lacks, all replicated; and
    ``gather`` sharded on any dim but the gathered one, in place of
    DTensor's own, whose masked partial result (a vocab-sharded gather)
    cannot be redistributed once a dim is selected away."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(torch.ops.aten.scatter_reduce.two)
    def _scatter_reduce(x, dim, index, src, reduce, include_self=True):
        return [([Replicate()],
                 [Replicate(), None, Replicate(), Replicate(), None, None])]

    @register_sharding(torch.ops.aten.gather.default)
    def _gather(x, dim, index, sparse_grad=False):
        out = [([Replicate()], [Replicate(), None, Replicate(), None])]
        for d in range(x.ndim):
            if d != dim % x.ndim:
                out.append(([Shard(d)], [Shard(d), None, Shard(d), None]))
        return out


@contextlib.contextmanager
def _strided_sizes_on_host():
    """DTensor computes a strided shard's local size and offset with
    small tensors of indices, read back with ``tolist``; under
    ``FakeTensorMode`` they would be fake and unreadable.  While this is
    entered that computation runs with no dispatch mode (it moves no
    data of the program)."""
    from torch.distributed.tensor import placement_types
    from torch.utils._python_dispatch import _disable_current_modes

    cls = getattr(placement_types, "_StridedShard", None)
    fn = getattr(cls, "local_shard_size_and_offset", None)
    if fn is None:
        yield
        return

    def on_host(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)

    cls.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = fn


def _local_shape(shape, spec, mesh) -> tuple:
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(n // common.axes_size(mesh, ax) if ax is not None else n
                 for n, ax in zip(shape, spec))


def _flat_pods(mesh):
    """The (2, 16, 16) ``("pod", "data", "model")`` mesh as (32, 16)
    ``("data", "model")``: the same ranks in the same places, "pod" and
    "data" one axis, so every spec places each block where the 3-D mesh
    does (the JAX package's DATA is ``("pod", "data")`` as one unit).
    DTensor plans a redistribution of a dim split over two mesh axes by
    a search too slow for a whole model; on this mesh it needs none."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(mesh.device_type,
                            (mesh.size(0) * mesh.size(1), mesh.size(2)),
                            mesh_dim_names=("data", "model"))


def _mining_specs(mesh, db_axes) -> tuple:
    """The mining step's blocks, as the JAX step's ``shard_map`` input
    specs name them: rows over the DP axes, tokens over "model"."""
    db = tuple(db_axes) if len(db_axes) > 1 else db_axes[0]
    return (P(db, "model", None), P(db), P(db, None), P(db, None), P(db),
            P(), P(), P(), P())


def _trace_cell(arch, shape: str, mesh, device: torch.device):
    """(counter, argument bytes, output bytes) of rank 0's program."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    _register_strategies()
    # the steps make their process groups here, from the mesh's real
    # tensor of ranks: outside the fake mode
    if arch.family == "mining":
        from ..mining.distributed import make_mining_step

        m = arch.shapes[shape].meta
        db_axes = common.dp_axes(mesh)
        step = make_mining_step(mesh, k=m["k"], db_axes=db_axes,
                                tok_axis="model")
        b = arch.batch_abstract(shape)
        abstract = tuple(b[n] for n in (
            "tokens", "gid", "phi", "psi", "valid", "existing"))
        abstract += (0, 0, 0)  # nv, n_pat, mode: int32 scalars
        specs = _mining_specs(mesh, db_axes)
        takes_global = True
    else:
        step, abstract = arch.make_step(shape, mesh)
        takes_global = getattr(step, "takes_global", False)
        if not takes_global and mesh.ndim == 3:
            mesh = _flat_pods(mesh)
            step, abstract = arch.make_step(shape, mesh)
        specs = arch.arg_specs(shape, mesh, abstract)

    leaves = common.tree_leaves(abstract)
    spec_leaves = common.tree_flatten_up_to(abstract, specs)
    with FakeTensorMode():
        def make(x, spec):
            """The rank's argument: the global tensor, or a DTensor
            over its block."""
            if not isinstance(x, torch.Tensor):
                return x
            if takes_global:
                return torch.empty(x.shape, dtype=x.dtype, device=device)
            local = torch.empty(_local_shape(x.shape, spec, mesh),
                                dtype=x.dtype, device=device)
            return DTensor.from_local(
                local, mesh, common.spec_placements(spec, mesh),
                run_check=False, shape=x.shape,
                stride=torch.empty(x.shape, device="meta").stride())

        made = [make(x, s) for x, s in zip(leaves, spec_leaves)]
        local = [x._local_tensor if isinstance(x, DTensor) else x
                 for x in made]
        counter = _Counter([x for x in local if isinstance(x, torch.Tensor)])
        with counter, implicit_replication(), _strided_sizes_on_host():
            out = step(*common.tree_unflatten(abstract, made))
        arg_bytes = 0
        for x, t, s in zip(leaves, local, spec_leaves):
            if not isinstance(x, torch.Tensor):
                arg_bytes += 4  # a Python int stands for an int32 scalar
            elif id(t) in counter.read:
                arg_bytes += math.prod(_local_shape(x.shape, s, mesh)) * \
                    x.element_size()
        out_bytes = sum(
            _nbytes(t._local_tensor if isinstance(t, DTensor) else t)
            for t in common.tree_leaves(out) if isinstance(t, torch.Tensor))
        del out
    return counter, arg_bytes, out_bytes


def lower_cell(arch_id: str, shape: str, multi_pod: bool,
               device: DeviceLike = None) -> dict:
    """Trace one (arch x shape x mesh) cell; return stats."""
    arch = get_arch(arch_id)
    n_chips = 512 if multi_pod else 256
    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        dev = torch.device(mesh.device_type)
        t0 = time.time()
        counter, arg_bytes, out_bytes = _trace_cell(arch, shape, mesh, dev)
        t_trace = time.time() - t0
    temp = counter.peak_bytes
    roof = analysis.from_counts(counter.flops, counter.bytes,
                                counter.collectives, n_chips,
                                arch.model_flops(shape))
    return {
        "arch": arch_id,
        "shape": shape,
        "mesh": _mesh_name(multi_pod),
        "n_chips": n_chips,
        "ok": True,
        "device": dev.type,
        "t_trace_s": round(t_trace, 2),
        "memory": {
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": temp,
            "per_device_total_bytes": arg_bytes + temp,
        },
        "collectives": counter.collectives,
        "kernels": counter.kernels,
        "replicated_fallbacks": counter.fallbacks,
        "roofline": roof.to_dict(),
    }


def run_cell_to_file(arch_id, shape, multi_pod, out_dir,
                     device: DeviceLike = None) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch_id}__{shape}__{'multi' if multi_pod else 'single'}"
    path = os.path.join(out_dir, tag + ".json")
    try:
        res = lower_cell(arch_id, shape, multi_pod, device)
        print(f"[dryrun] OK   {tag}  trace={res['t_trace_s']}s "
              f"bottleneck={res['roofline']['bottleneck']}", flush=True)
    except Exception as e:
        res = {
            "arch": arch_id, "shape": shape,
            "mesh": _mesh_name(multi_pod),
            "ok": False, "error": str(e),
            "traceback": traceback.format_exc(),
        }
        print(f"[dryrun] FAIL {tag}: {e}", flush=True)
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    return res


def all_cells(include_mining=True):
    cells = []
    for arch_id in list_archs(include_extra=include_mining):
        arch = get_arch(arch_id)
        for shape in arch.shapes:
            cells.append((arch_id, shape))
    return cells


def main(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default=None,
                    help="the mesh's device: cuda (default; raises "
                         "without one) or cpu")
    args = ap.parse_args(argv)

    if args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in get_arch(args.arch).shapes]
    else:
        cells = all_cells()

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch_id, shape in cells:
        for multi in meshes:
            tag = (f"{arch_id}__{shape}__"
                   f"{'multi' if multi else 'single'}")
            path = os.path.join(args.out, tag + ".json")
            if args.skip_existing and os.path.exists(path):
                try:
                    with open(path) as f:
                        ok = json.load(f).get("ok")
                except (OSError, ValueError):
                    ok = False
                if ok:
                    print(f"[dryrun] SKIP {tag}")
                    continue
            run_cell_to_file(arch_id, shape, multi, args.out, args.device)


if __name__ == "__main__":
    main()
