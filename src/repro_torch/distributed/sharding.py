"""Sharding: the query layer's shard layouts (device = HBM
pseudo-channel, Figs. 5-7) and the LM harness's logical-axis rules.

The query stack stripes row streams across ``n_shards`` shards, each
playing one pseudo-channel of the paper's channel-count sweep.  One H100
is one device, so a shard is a contiguous slice of each sharded column on
the executor's card and the shards run one after another; a layout names
the slicing, not a set of devices.  ``ShardLayout.key()`` joins plan
fingerprints and the executor's compiled-plan keys, so a 1-shard and an
8-shard plan never alias.

``hash_shard`` and ``partition_to_shards`` are the shuffle join's
repartitioning: both join sides go through the same owner function, so
matching keys land on the same shard.

The model half (logical-axis rules for the LM harness, after the
reference's ``ShardingRules`` / ``resolve``) maps every logical tensor dim
to a mesh axis:

  batch      activations' batch dim            -> (pod, data)
  seq        sequence dim                      -> None (or data under CP)
  kv_seq     KV-cache sequence dim             -> model (flash-decoding)
  heads      q-head dim                        -> model (when divisible)
  kv_heads   kv-head dim                       -> model (when divisible)
  mlp        d_ff dim                          -> model
  vocab      vocabulary dim                    -> model
  experts    expert dim                        -> model (EP) or None
  moe_mlp    expert d_ff dim                   -> model (expert-TP only)
  fsdp       weight shard dim (ZeRO-3 style)   -> data
  ssm_heads  SSD head dim                      -> model (when divisible)
  head_dim   rope-free head_dim TP (whisper)   -> model

The models take these rules (``rules=None`` by default, and then, or on
plain tensors, nothing changes): they pin activation layouts with
``constrain`` where the reference does, and run on each rank's block
(``on_shards``, a ``local_map``) what DTensor cannot propagate.

``spec`` gives the reference's ``PartitionSpec`` as a plain tuple;
``placements`` the DTensor placements of that spec over a ``DeviceMesh``
(``Shard(d)`` on each mesh dim that tensor dim ``d`` names, major to
minor, ``Replicate()`` elsewhere), so that each rank holds the block the
reference puts on the device at the same mesh coordinate.  The rules
resolve against a ``DeviceMesh`` or an ``AbstractMesh``
(``launch.mesh``), whose sizes alone decide them.  ``of_block`` and
``from_whole`` make the DTensor of this rank's block (``local_block``),
``whole`` gathers one back.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import (
    Mesh, axis_names, axis_sizes, data_axes, mesh_axis,
)

QUERY_SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """A query-layer striping: ``n_shards`` contiguous slices of one
    device's columns, one channel each."""

    n_shards: int
    axis: str = QUERY_SHARD_AXIS

    def __post_init__(self) -> None:
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")

    def key(self) -> tuple:
        """Hashable identity folded into fingerprints and cache keys (the
        reference's tuple, so fingerprints match)."""
        return ("shard_layout", self.n_shards, self.axis)


def hash_shard(keys: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Shard owner of each key: plain modulo, in int32.  Keys are
    validated non-negative by the eager engine layer, so the modulo is a
    total function here."""
    return (keys % n_shards).to(torch.int32)


def partition_to_shards(shard_ids: torch.Tensor,
                        values: Sequence[torch.Tensor], n_shards: int,
                        cap: int, fills: Sequence[torch.Tensor]
                        ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                                   torch.Tensor]:
    """Scatter rows into fixed-capacity per-shard buckets (the shuffle).

    ``values`` are (N,) tensors sharing ``shard_ids``; each is scattered
    with one stable permutation into a copy of its ``fills[i]`` template
    of shape (n_shards, cap), whose contents are the pad pattern.  Within
    a shard, rows keep their input order.  Rows beyond a shard's ``cap``
    are dropped, but ``counts`` stays exact (``bincount``), so one retry
    with the measured capacity always suffices.  Returns (buckets, counts
    (n_shards,) int32, overflowed (0-d bool))."""
    n = shard_ids.shape[0]
    sid64 = shard_ids.to(torch.int64)
    order = torch.argsort(sid64, stable=True)
    sid = sid64[order]
    counts = torch.bincount(sid64, minlength=n_shards)[:n_shards]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, dtype=torch.int64, device=shard_ids.device) \
        - starts[sid]
    keep = pos < cap
    rows, cols = sid[keep], pos[keep]
    buckets = []
    for f, v in zip(fills, values):
        b = f.clone()
        b[rows, cols] = v[order][keep].to(b.dtype)
        buckets.append(b)
    counts = counts.to(torch.int32)
    return tuple(buckets), counts, (counts > cap).any()


# --------------------------------------------------------------------------- #
# the model half: logical-axis rules for the LM harness
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Resolved logical -> mesh-axis mapping for one (arch, mesh) pair."""

    mesh: Mesh
    batch: tuple[str, ...]
    seq: Optional[str]                 # context parallelism when set
    kv_seq: Optional[str]              # KV-cache sequence dim (flash-decoding)
    heads: Optional[str]
    kv_heads: Optional[str]
    mlp: Optional[str]
    vocab: Optional[str]
    experts: Optional[str]
    moe_mlp: Optional[str]             # expert d_ff dim (expert-TP only)
    fsdp: Optional[str]
    ssm_heads: Optional[str]
    head_dim: Optional[str]            # rope-free head_dim TP (whisper)

    def spec(self, *logical: Optional[str]) -> tuple:
        """The reference's ``PartitionSpec`` of these logical dims as a
        tuple: per dim ``None``, an axis name, or a tuple of names (a
        one-name tuple is the name, as ``PartitionSpec`` normalises it)."""
        out = []
        for ax in logical:
            v = None if ax is None else getattr(self, ax)
            if isinstance(v, tuple):
                v = (v[0] if len(v) == 1 else v) if v else None
            out.append(v)
        return tuple(out)

    def placements(self, *logical: Optional[str]) -> tuple:
        """DTensor placements over ``self.mesh``: for each mesh dim,
        ``Shard(d)`` if tensor dim ``d`` names it, else ``Replicate()``.
        A dim over several axes names them in mesh order (major first)."""
        names = axis_names(self.mesh)
        out: list = [Replicate()] * len(names)
        for d, axes in enumerate(self.spec(*logical)):
            if axes is None:
                continue
            axes_t = axes if isinstance(axes, tuple) else (axes,)
            dims = [names.index(a) for a in axes_t]
            if dims != sorted(dims):
                raise ValueError(f"dim {d} over {axes_t}: not in the mesh's "
                                 f"major-to-minor order {names}")
            for m in dims:
                if out[m] != Replicate():
                    raise ValueError(f"mesh axis {names[m]!r} shards two "
                                     f"dims of {logical}")
                out[m] = Shard(d)
        return tuple(out)

    def named(self, *logical: Optional[str]) -> tuple:
        """``(mesh, placements)``: what a DTensor of these dims is laid
        out by (the reference's ``NamedSharding``)."""
        return self.mesh, self.placements(*logical)

    def constrain(self, x, *logical: Optional[str]):
        """A DTensor redistributed to these dims' placements; a plain
        tensor unchanged (``with_sharding_constraint`` on one device)."""
        if not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, self.placements(*logical))


def resolve(cfg: ArchConfig, mesh: Mesh, shape=None, *,
            context_parallel_decode: bool = False,
            fsdp: bool = True) -> ShardingRules:
    """The reference's padding / replication policy, line for line.

    ``shape`` (a ShapeConfig) refines the rules per step kind: serve steps
    shard the KV-cache sequence dim over ``model`` (the flash-decoding
    layout), and batch sharding is dropped when the global batch does not
    divide the dp axes (long_500k's batch 1)."""
    tp = mesh_axis(mesh, "model")
    dp_axes = data_axes(mesh)
    has_data = "data" in axis_names(mesh)

    kv_seq = None
    if shape is not None:
        dp_size = 1
        for a in dp_axes:
            dp_size *= mesh_axis(mesh, a)
        if shape.global_batch % max(dp_size, 1):
            dp_axes = ()
        if shape.kind in ("prefill", "decode") and tp > 1 \
                and shape.seq_len % tp == 0 and cfg.kv_tp(tp) != tp:
            # flash-decoding cache layout; not needed (and conflicting)
            # when the kv heads themselves shard over the model axis
            kv_seq = "model"

    attn_tp = cfg.attn_tp(tp)
    heads = "model" if (tp > 1 and attn_tp == tp) else None
    kv_heads = "model" if (tp > 1 and cfg.kv_tp(tp) == tp) else None
    mlp = "model" if tp > 1 else None
    vocab = "model" if tp > 1 else None
    # EP owns the model axis for expert weights (experts divide it);
    # otherwise expert-TP shards each expert's d_ff over the model axis
    experts = "model" if (cfg.n_experts and cfg.expert_parallel(tp)) \
        else None
    moe_mlp = "model" if (cfg.n_experts and tp > 1 and experts is None) \
        else None
    ssm_heads = "model" if (cfg.ssm_state and tp > 1
                            and cfg.n_ssm_heads % tp == 0) else None
    seq = "data" if (context_parallel_decode and has_data) else None

    return ShardingRules(
        mesh=mesh, batch=dp_axes, seq=seq, kv_seq=kv_seq, heads=heads,
        kv_heads=kv_heads, mlp=mlp, vocab=vocab, experts=experts,
        moe_mlp=moe_mlp, fsdp="data" if (fsdp and has_data) else None,
        ssm_heads=ssm_heads,
        head_dim="model" if (tp > 1 and cfg.head_dim_tp(tp) == tp) else None,
    )


# --------------------------------------------------------------------------- #
# parameter spec trees: every leaf a LogicalArray (shape, logical dims,
# dtype), mapped to placements or to meta stand-ins
# --------------------------------------------------------------------------- #

@dataclasses.dataclass
class LogicalArray:
    """Shape + logical axes of a parameter, with no storage."""

    shape: tuple[int, ...]
    logical: tuple[Optional[str], ...]
    dtype: torch.dtype

    def sds(self, rules: ShardingRules) -> torch.Tensor:
        """A meta tensor of this shape and type that carries the leaf's
        ``device_mesh`` and ``placements`` (a DTensor's names for them):
        a stand-in that allocates nothing."""
        t = torch.empty(self.shape, dtype=self.dtype, device="meta")
        t.device_mesh, t.placements = rules.named(*self.logical)
        return t


def tree_map(fn, *trees, is_leaf=None, path: str = ""):
    """``fn(path, *leaves)`` over the leaves of trees of one structure (the
    first's): nested dicts, lists and tuples, a container that
    ``is_leaf`` accepts taken whole; a leaf's path is the reference's
    ``keystr`` form (``['layers.0.attn.wq']``)."""
    t0 = trees[0]
    if is_leaf is None or not is_leaf(t0):
        if isinstance(t0, dict):
            return {k: tree_map(fn, *(t[k] for t in trees), is_leaf=is_leaf,
                                path=f"{path}[{k!r}]") for k in t0}
        if isinstance(t0, (list, tuple)):
            return type(t0)(tree_map(fn, *parts, is_leaf=is_leaf,
                                     path=f"{path}[{i}]")
                            for i, parts in enumerate(zip(*trees)))
    return fn(path, *trees)


def tree_shardings(tree, rules: ShardingRules):
    """A tree of LogicalArray -> the same tree of ``(mesh, placements)``."""
    return tree_map(lambda _, la: rules.named(*la.logical), tree)


def tree_sds(tree, rules: ShardingRules):
    """A tree of LogicalArray -> the same tree of meta stand-ins."""
    return tree_map(lambda _, la: la.sds(rules), tree)


def validate_divisibility(tree, rules: ShardingRules) -> list[str]:
    """Every sharded dim must divide its mesh-axis product; returns one
    problem per dim that does not."""
    sizes = axis_sizes(rules.mesh)
    problems: list[str] = []

    def check(path: str, la: Any) -> None:
        for dim, axes in zip(la.shape, rules.spec(*la.logical)):
            if axes is None:
                continue
            axes_t = axes if isinstance(axes, tuple) else (axes,)
            k = 1
            for a in axes_t:
                k *= sizes.get(a, 1)
            if dim % k:
                problems.append(f"{path}: dim {dim} not divisible by {k} "
                                f"({axes})")

    tree_map(check, tree)
    return problems


def local_block(shape: Sequence[int], mesh: DeviceMesh,
                placements: Sequence) -> tuple:
    """This rank's block of an array of ``shape`` under
    ``placements`` over ``mesh``: an index tuple of slices.  A dim sharded
    on several mesh dims is chunked by each in turn, major first, in
    ``torch.chunk``'s sizes (as DTensor lays it out)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    lo = [0] * len(shape)
    hi = list(shape)
    for m, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        d, n, c = p.dim, mesh.size(m), coord[m]
        length = hi[d] - lo[d]
        step = -(-length // n)
        start = min(lo[d] + c * step, hi[d])
        lo[d], hi[d] = start, min(start + step, hi[d])
    return tuple(slice(a, b) for a, b in zip(lo, hi))


def of_block(local: torch.Tensor, mesh: DeviceMesh, placements: Sequence,
             shape: Sequence[int]) -> DTensor:
    """The DTensor of global ``shape`` laid out by ``placements`` over
    ``mesh`` whose local tensor is ``local``, this rank's block
    (``local_block``'s): no check, no bytes cross the group."""
    full = torch.empty(tuple(shape), device="meta")
    return DTensor.from_local(local, mesh, tuple(placements),
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def from_whole(t: torch.Tensor, mesh: DeviceMesh,
               placements: Sequence) -> DTensor:
    """``of_block`` of this rank's block of ``t``, a tensor every rank
    holds whole and equal.  A block less than the whole is a copy, which
    keeps nothing of ``t`` alive."""
    block = t[local_block(t.shape, mesh, placements)]
    block = block.contiguous() if block.numel() == t.numel() else \
        block.clone(memory_format=torch.contiguous_format)
    return of_block(block, mesh, placements, t.shape)


def whole(x):
    """``x`` gathered whole on every rank where it is a DTensor (a
    collective), else ``x`` itself."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# --------------------------------------------------------------------------- #
# the models' sharded pieces: constants beside DTensors, and the parts run
# on each rank's block
# --------------------------------------------------------------------------- #

def is_sharded(rules: Optional[ShardingRules], x) -> bool:
    """Whether a model call runs distributed: rules given and ``x`` a
    DTensor."""
    return rules is not None and isinstance(x, DTensor)


def active(rules: Optional[ShardingRules], x) -> Optional[ShardingRules]:
    """The rules where ``x`` is a DTensor they lay out, else None: a model
    call on plain tensors runs as on one card."""
    return rules if is_sharded(rules, x) else None


def constrain(rules: Optional[ShardingRules], x, *logical: Optional[str]):
    """``rules.constrain(x, *logical)``; ``x`` itself without rules."""
    return x if rules is None else rules.constrain(x, *logical)


def replicated_like(t: torch.Tensor, ref) -> torch.Tensor:
    """A constant built inside a forward (positions, a mask, a table) as a
    DTensor replicated over ``ref``'s mesh when ``ref`` is a DTensor and
    ``t`` is not; else ``t`` itself."""
    if not isinstance(ref, DTensor) or isinstance(t, DTensor):
        return t
    mesh = ref.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def axis_coordinate(rules: ShardingRules, axis: str) -> int:
    """This rank's coordinate on mesh axis ``axis`` (0 where the mesh has
    no such axis)."""
    names = axis_names(rules.mesh)
    if axis not in names:
        return 0
    return rules.mesh.get_local_rank(axis)


def mesh_dim(rules: ShardingRules, axis: str) -> int:
    """The index of mesh axis ``axis`` in the rules' ``DeviceMesh`` (what a
    functional collective's ``(mesh, dim)`` group names)."""
    return list(axis_names(rules.mesh)).index(axis)


def dim_block(rules: ShardingRules, n: int, logical: Optional[str]) -> slice:
    """This rank's block of a dim of size ``n`` laid out by ``logical``."""
    if logical is None:
        return slice(0, n)
    return local_block((n,), rules.mesh, rules.placements(logical))[0]


def _grad_placements(inp: tuple, outs: list) -> tuple:
    """An input replicated on a mesh dim where an output is sharded or
    partial was read in part by each rank: its gradient is partial
    there."""
    out = list(inp)
    for m, p in enumerate(inp):
        if isinstance(p, Replicate) and any(
                not isinstance(o[m], Replicate) for o in outs):
            out[m] = Partial()
    return tuple(out)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: a rank's block's
    gradient may be a strided view, which DTensor's backward ops upstream
    (a matmul's) view as they are."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _SettleGrad(torch.autograd.Function):
    """The identity, whose gradient (a DTensor) is redistributed to
    ``placements`` as it passes: a partial gradient is summed here, before
    the ops upstream see it."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def on_shards(rules: ShardingRules, fn, out_specs: tuple, in_specs: tuple,
              *args):
    """``fn`` on each rank's blocks (``torch.distributed.tensor.
    experimental.local_map``): every DTensor argument is redistributed to
    the placements of its logical dims in ``in_specs`` (None for an
    argument that is no DTensor) and passed as its local block; ``fn``'s
    outputs become DTensors laid out by ``out_specs``, each a tuple of
    logical dims or of ready placements (``Partial`` where the ranks' blocks
    sum).  An input replicated where an output is split gets a partial
    gradient, summed (redistributed to the input's placements) before it
    leaves; so an output that every rank computes whole beside a split
    one must be given as ``Partial`` too, each rank's block its share
    (divided by the ranks that compute it), or its gradient is counted
    once a rank.  Without rules, or with no DTensor argument,
    ``fn(*args)`` (one card)."""
    if rules is None or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)

    def placements(spec):
        if spec is None:
            return None
        if spec and all(isinstance(p, (Replicate, Shard, Partial))
                        for p in spec):
            return tuple(spec)
        return rules.placements(*spec)

    outs = [placements(s) for s in out_specs]
    ins = tuple(placements(s) if isinstance(a, DTensor) else None
                for s, a in zip(in_specs, args))
    grads = tuple(None if p is None else _grad_placements(p, outs)
                  for p in ins)
    args = tuple(_SettleGrad.apply(a.redistribute(rules.mesh, p), p)
                 if p is not None and g != p and a.requires_grad else a
                 for a, p, g in zip(args, ins, grads))

    def local(*blocks):
        return fn(*(_ContiguousGrad.apply(b) if isinstance(b, torch.Tensor)
                    and b.requires_grad else b for b in blocks))
    return local_map(local, out_placements=tuple(outs), in_placements=ins,
                     in_grad_placements=grads, device_mesh=rules.mesh,
                     redistribute_inputs=True)(*args)
