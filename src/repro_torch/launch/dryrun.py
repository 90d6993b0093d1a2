"""The multi-pod dry run: for every (architecture x input shape) cell, run
the port's real step (``train.train_loop.step_and_specs``) once on a
fake process group of the production mesh's size, with every tensor a
fake one, and record what one rank's share of the step costs: FLOPs,
bytes, collective traffic, memory and a three-term roofline
(``analysis.roofline``, H100 constants).  Results accumulate in a
resumable JSON (``build/dryrun_results_torch.json``) that
``analysis.report`` renders.

How a cell runs:
  * a fake process group (``torch.testing._internal.distributed.fake_pg``,
    backend ``"fake"``) of the mesh's size, and a ``DeviceMesh`` over it
    with ``launch.mesh.make_production_mesh``'s axes; the group is
    destroyed when the cell ends.  A default process group that already
    exists is refused: the dry run never runs on a real group or a
    smaller mesh;
  * the step's stand-ins become DTensors of fake local blocks laid out by
    the rules, and the step runs under ``FakeTensorMode`` (nothing is
    allocated): DTensor's sharding propagation inserts the collectives
    that GSPMD inserts in the reference, and the models run their kernels'
    calls on each rank's block (``sharding.on_shards``).  On fake tensors
    B7's and B8's wrappers call their kernels' function as one op each,
    forward and backward (``repro_torch::flash_attention``,
    ``repro_torch::ssd_scan`` and their backwards), so the count holds
    the kernels' own cost (their formulas in ``attention_flops`` and
    ``ssd_flops``, registered with ``torch.utils.flop_counter``; their
    operands and results as bytes), not the plain versions' S x S scores
    and intra-chunk intermediates;
  * a dispatch mode counts every op.  An op on DTensors is counted once,
    globally (``torch.utils.flop_counter``'s formulas on the global
    shapes), divided by the product of the mesh dims on which its output
    is ``Shard`` or ``Partial``: replicated work stays counted, as XLA
    counts it.  An op on plain tensors (inside a rank's block) is counted
    as it is.  Bytes are the local bytes of each op's inputs and output
    (views and metadata ops move none).  Collectives are counted at the
    ``torch.ops._c10d_functional`` level, by their result bytes and group
    size, including those DTensor inserts inside an op's dispatch (a
    second mode sees them).  On the CPU the fake group's backend turns an
    all-to-all into an all-gather and a chunk, so a reshard between two
    sharded dims shows as an all-gather;
  * memory: ``argument_bytes`` the stand-ins' local bytes,
    ``output_bytes`` the outputs' that are no argument's,
    ``temp_bytes`` the peak of live local intermediates, ``alias_bytes``
    the arguments the step updates in place;
  * the model's repeated units (``count_units``) are counted each on its
    own and recorded; the port's layers are unrolled, so the step's count
    already holds every layer and the units are not added to it.

Run ``python -m repro_torch.launch.dryrun --all`` (``--multi-pod`` for
the 512-rank mesh, ``--arch`` / ``--shape`` for some cells, ``--force``
to redo cached ones).  It needs no card.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor, Replicate
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map_only
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis.collectives import (
    FUNCTIONAL_KINDS, CollectiveRecord, collective_stats, op_histogram,
)
from repro_torch.analysis.roofline import from_measurements
from repro_torch.configs.base import (
    SHAPES, ArchConfig, ShapeConfig, all_archs, dryrun_cells, get_arch,
)
from repro_torch.distributed.sharding import local_block, resolve
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.models.registry import bundle
from repro_torch.train.train_loop import step_and_specs

RESULTS = Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_results_torch.json"


# --------------------------------------------------------------------------- #
# the fake process group
# --------------------------------------------------------------------------- #

def mesh_name(mesh: AbstractMesh) -> str:
    """``pod16x16`` / ``pod2x16x16`` for the production meshes, else
    ``mesh`` and the sizes (``mesh2x2``)."""
    sizes = "x".join(str(n) for n in mesh.axis_sizes)
    if tuple(mesh.axis_names) in (("data", "model"),
                                  ("pod", "data", "model")) \
            and sizes in ("16x16", "2x16x16"):
        return f"pod{sizes}"
    return f"mesh{sizes}"


@contextlib.contextmanager
def fake_group(mesh: AbstractMesh):
    """A ``DeviceMesh`` of ``mesh``'s axes over a fake process group of its
    size (this process is rank 0), destroyed on exit.  Refuses to start
    while a default process group exists."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run needs its own fake process group: "
                           "a default process group already exists")
    size = math.prod(mesh.axis_sizes)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.axis_sizes),
                               mesh_dim_names=tuple(mesh.axis_names))
    finally:
        dist.destroy_process_group()


def fake_args(args, mesh: DeviceMesh):
    """The step's meta stand-ins (``LogicalArray.sds``) as DTensors of fake
    local blocks over ``mesh``: call under ``FakeTensorMode``."""
    def one(t):
        placements = getattr(t, "placements", None)
        if placements is None:
            placements = (Replicate(),) * mesh.ndim
        blk = local_block(t.shape, mesh, placements)
        local = torch.empty([s.stop - s.start for s in blk], dtype=t.dtype)
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return tree_map_only(torch.Tensor, one, args)


# --------------------------------------------------------------------------- #
# counting one rank's share of a step
# --------------------------------------------------------------------------- #

def _local(t):
    return t._local_tensor if isinstance(t, DTensor) else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _collective(func, args, out) -> Optional[CollectiveRecord]:
    if func.namespace != "_c10d_functional":
        return None
    kind = FUNCTIONAL_KINDS.get(func._overloadpacket.__name__)
    if kind is None:
        return None
    group = next(a for a in reversed(args) if isinstance(a, str))
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
    return CollectiveRecord(kind, sum(_nbytes(t) for t in outs),
                            _resolve_process_group(group).size())


class _InnerCollectives(TorchDispatchMode):
    """Sees the local ops that DTensor's dispatch runs for one DTensor op
    and records its collectives."""

    def __init__(self, records: list):
        super().__init__()
        self.records = records

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        rec = _collective(func, args, out)
        if rec is not None:
            self.records.append(rec)
        return out


def per_device_flops(global_flops: float, out) -> float:
    """An op's global FLOPs divided by the product of the mesh dims on
    which its (first DTensor) output is ``Shard`` or ``Partial``."""
    outs = [t for t in tree_flatten(out)[0] if isinstance(t, DTensor)]
    if not outs:
        return float(global_flops)
    o = outs[0]
    split = 1
    for m, p in enumerate(o.placements):
        if not isinstance(p, Replicate):
            split *= o.device_mesh.size(m)
    return float(global_flops) / split


class StepCounter(TorchDispatchMode):
    """FLOPs, bytes, collectives, op names and the peak of live local
    intermediates of the ops run under it (see the module)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.records: list = []
        self.ops: list = []
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def _allocated(self, func, args, out) -> None:
        if func.is_view or func._schema.is_mutable:
            return
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                loc = _local(t)
                n = _nbytes(loc)
                self.live += n
                weakref.finalize(loc, self._free, n)
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "prim":
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            with _InnerCollectives(self.records):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
            rec = _collective(func, args, out)
            if rec is not None:
                self.records.append(rec)
                return out
            if func.namespace == "_c10d_functional":
                return out
        flop_fn = flop_registry.get(func._overloadpacket)
        if flop_fn is not None:
            self.flops += per_device_flops(
                flop_fn(*args, **kwargs, out_val=out), out)
        if not func.is_view:
            tensors = [t for t in tree_flatten((args, kwargs, out))[0]
                       if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in tensors)
        self.ops.append(f"{func.namespace}.{func._overloadpacket.__name__}")
        self._allocated(func, args, out)
        return out


def _storages(tree) -> dict:
    """{storage: a tensor of the tree on it} (a DTensor's local storage)."""
    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, torch.Tensor):
            out[_local(t).untyped_storage()._cdata] = t
    return out


def count_step(fn, args, mesh: DeviceMesh) -> dict:
    """Run ``fn`` once over ``args`` (meta stand-ins) as fake DTensors on
    ``mesh``, under ``StepCounter``: its counts and memory."""
    with FakeTensorMode():
        fargs = fake_args(args, mesh)
        arg_store = _storages(fargs)
        versions = {k: (t._version, _local(t)._version)
                    for k, t in arg_store.items()}
        counter = StepCounter()
        with counter:
            out = fn(*fargs)
        aliased = sum(_nbytes(t) for k, t in arg_store.items()
                      if (t._version, _local(t)._version) != versions[k])
        outs = {k: t for k, t in _storages(out).items()
                if k not in arg_store}
        memory = {"argument_bytes": sum(_nbytes(t)
                                        for t in arg_store.values()),
                  "output_bytes": sum(_nbytes(t) for t in outs.values()),
                  "temp_bytes": counter.peak,
                  "alias_bytes": aliased}
    return {"flops": counter.flops, "bytes": counter.bytes,
            "coll": collective_stats(counter.records), "ops": counter.ops,
            "memory": memory}


# --------------------------------------------------------------------------- #
# one cell
# --------------------------------------------------------------------------- #

def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             mesh: Optional[AbstractMesh] = None,
             context_parallel_decode: bool = False, save_hist: bool = True,
             cfg: Optional[ArchConfig] = None,
             shape: Optional[ShapeConfig] = None) -> dict:
    """One cell on the production mesh (``mesh`` in its place, and
    ``cfg`` / ``shape`` in place of the named ones, for tests); the
    reference's cell fields."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    name = mesh_name(mesh)
    cell = {"arch": cfg.name, "shape": shape.name, "mesh": name}

    reason = cfg.skip_reason(shape)
    if reason:
        cell.update(status="skipped", reason=reason)
        return cell

    t0 = time.time()
    chips = math.prod(mesh.axis_sizes)
    cp = context_parallel_decode or (
        shape.name == "long_500k" and cfg.family == "hybrid")
    with fake_group(mesh) as dmesh:
        rules = resolve(cfg, dmesh, shape, context_parallel_decode=cp)
        if shape.global_batch == 1:
            # one row stays whole: DTensor cannot flatten a split dim of
            # size 1 (the data axes are then of size 1 too)
            rules = dataclasses.replace(rules, batch=())
        fn, args = step_and_specs(cfg, shape, rules)
        t_lower = time.time() - t0
        step = count_step(fn, args, dmesh)
        t_compile = time.time() - t0 - t_lower
        units_meta = []
        for uname, ufn, uargs, mult in bundle(cfg).count_units(shape, rules):
            u = count_step(ufn, uargs, dmesh)
            units_meta.append({"name": uname, "mult": mult,
                               "flops": u["flops"], "bytes": u["bytes"],
                               "coll_operand":
                                   u["coll"].total_operand_bytes})

    coll = step["coll"]
    rl = from_measurements(
        cfg, shape, name, chips, flops_per_dev=step["flops"],
        bytes_per_dev=step["bytes"], coll_operand=coll.total_operand_bytes,
        coll_wire=coll.total_wire_bytes)
    cell.update(
        status="ok",
        chips=chips,
        lower_s=round(t_lower, 1),
        compile_s=round(t_compile, 1),
        flops_per_dev=step["flops"],
        bytes_per_dev=step["bytes"],
        count_units=units_meta,
        collectives={k: int(v) for k, v in coll.counts.items()},
        coll_operand_bytes=coll.total_operand_bytes,
        coll_operand_by_kind={k: float(v)
                              for k, v in coll.operand_bytes.items()},
        coll_wire_bytes=coll.total_wire_bytes,
        memory=step["memory"],
        roofline=rl.to_dict(),
    )
    if save_hist:
        cell["op_histogram"] = op_histogram(step["ops"], top=20)
    return cell


def load_results(path: Path = RESULTS) -> dict:
    if path.exists():
        return json.loads(path.read_text())
    return {}


def save_results(res: dict, path: Path = RESULTS) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(res, indent=1, sort_keys=True))


def cell_key(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}|{shape}|{mesh}"


def run_guarded(arch: str, shape_name: str, multi_pod: bool, **kw) -> dict:
    """``run_cell``, a cell that raises stored as ``status: error`` with
    its trace."""
    try:
        return run_cell(arch, shape_name, multi_pod, **kw)
    except Exception as e:                      # noqa: BLE001
        mesh = kw.get("mesh") or make_production_mesh(multi_pod=multi_pod)
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name(mesh),
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "trace": traceback.format_exc()[-2000:]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every (arch x shape) on the chosen mesh")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--results", type=Path, default=RESULTS,
                    help="the results file (default: %(default)s)")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(c.name, s.name) for c, s, _ in dryrun_cells()]
    else:
        archs = [args.arch] if args.arch else sorted(all_archs())
        shapes = [args.shape] if args.shape else list(SHAPES)
        todo = [(a, s) for a in archs for s in shapes]

    name = mesh_name(make_production_mesh(multi_pod=args.multi_pod))
    res = load_results(args.results)
    for arch, shape in todo:
        key = cell_key(arch, shape, name)
        if not args.force and key in res and \
                res[key].get("status") in ("ok", "skipped"):
            print(f"[skip-cached] {key}")
            continue
        print(f"[dryrun] {key} ...", flush=True)
        cell = run_guarded(arch, shape, args.multi_pod)
        res[key] = cell
        save_results(res, args.results)
        st = cell.get("status")
        if st == "ok":
            rl = cell["roofline"]
            print(f"  ok: compile={cell['compile_s']}s "
                  f"t_comp={rl['t_compute']:.4f}s "
                  f"t_mem={rl['t_memory']:.4f}s "
                  f"t_coll={rl['t_collective']:.4f}s "
                  f"bound={rl['bottleneck']} "
                  f"mfu_bound={rl['mfu_bound']:.3f}", flush=True)
        else:
            print(f"  {st}: {cell.get('reason') or cell.get('error')}",
                  flush=True)


if __name__ == "__main__":
    main()
