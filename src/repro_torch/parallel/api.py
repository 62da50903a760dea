"""Logical-axis sharding: the distribution layer (port of
``repro.parallel.api``).

Models annotate tensors with *logical* axis names ("batch", "seq",
"embed", "heads", "kv_heads", "mlp", "experts", "vocab", ...).  A
:class:`ShardingRules` maps logical names to mesh axes; the same model code
runs on one device and on a mesh.

Default production rules (DESIGN.md section 5):
  batch   -> ('pod', 'data')     DP across pods and the data axis
  seq     -> 'model'             sequence-parallel residual stream
  heads/mlp/experts/vocab -> 'model'   Megatron TP / expert parallelism
  embed   -> None (activations) ; parameters get FSDP over 'data' via
  :func:`param_spec`.

A spec is a tuple with one entry a tensor dim: ``None``, a mesh axis name,
or a tuple of names (the dim split over several axes, the first major), as
JAX's ``PartitionSpec``.  The spec functions read only the mesh's axis
names and sizes, so an :class:`AbstractMesh` stands in for a
``torch.distributed.device_mesh.DeviceMesh`` where no ranks exist.

How the port runs a mesh
------------------------
Every rank is one process of a ``torch.distributed`` world over a
``DeviceMesh``.  A sharded state leaf is a ``DTensor`` (:func:`distribute`,
:func:`placements`); activations between contractions are plain tensors
that hold the global value on every rank (the global view a JAX program
has).  The per-shard work is the contraction's: under a mesh,
``core.lowering`` slices each operand to its shard (:func:`enter`), runs
the kernel on the local shard with the full contraction extent, and
gathers the output back (:func:`leave`).  Both are autograd functions, so
a backward pass sums partial gradients over the mesh axes the way a
data/tensor-parallel step does.

The collectives are the c10d calls ``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce`` and ``all_to_all_single`` on the
mesh axes' process groups, made here and counted in
:data:`COLLECTIVE_BYTES`; DTensor's own redistribution (the functional
collectives, which hang on CUDA tensors over gloo) is never called.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist

# op -> bytes this process sent into it (the input's size)
COLLECTIVE_BYTES: collections.Counter = collections.Counter()


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes, no devices: the spec functions' mesh where no
    ranks exist (``jax.sharding.AbstractMesh``'s counterpart)."""

    shape: tuple
    axis_names: tuple


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a DeviceMesh or an AbstractMesh."""
    if isinstance(mesh, AbstractMesh):
        return dict(zip(mesh.axis_names, mesh.shape))
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def flat_axes(ax) -> tuple:
    """A rules entry as a tuple of mesh axis names."""
    if ax is None:
        return ()
    return ax if isinstance(ax, tuple) else (ax,)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Optional[object] = None
    # logical name -> mesh axis (or tuple of mesh axes) or None
    rules: dict = dataclasses.field(default_factory=dict)
    # FSDP: shard the largest non-TP parameter axis over these mesh axes.
    fsdp_axes: tuple = ()
    enabled: bool = False

    # Identity hash (the rules dict is unhashable) so a ShardingRules may
    # ride hashable carriers like lowering.Plan.mesh; equality stays
    # field-wise.
    __hash__ = object.__hash__

    def axis_extent(self, ax) -> int:
        """Total device count behind a rules entry (1 for None)."""
        if ax is None or self.mesh is None:
            return 1
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in flat_axes(ax))


_RULES = contextvars.ContextVar("repro_torch_sharding_rules",
                                default=ShardingRules())


def default_rules(mesh) -> ShardingRules:
    axes = tuple(axis_sizes(mesh))
    dp = tuple(a for a in ("pod", "data") if a in axes)
    dp = dp if len(dp) > 1 else (dp[0] if dp else None)
    tp = "model" if "model" in axes else None
    return ShardingRules(
        mesh=mesh,
        rules={
            "batch": dp,
            "seq": tp,            # sequence-parallel residual
            "seq_kv": tp,         # decode KV cache: seq over model
            "heads": tp,
            "kv_heads": tp,
            "mlp": tp,
            "experts": tp,
            "vocab": tp,
            "embed": None,
            "ssm_heads": tp,
            "state": None,
        },
        fsdp_axes=(("data",) if "data" in axes else ()),
        enabled=True,
    )


def current() -> ShardingRules:
    return _RULES.get()


@contextlib.contextmanager
def use_rules(rules: ShardingRules):
    token = _RULES.set(rules)
    try:
        yield rules
    finally:
        _RULES.reset(token)


def activation_spec(shape, logical_axes, rules: ShardingRules) -> tuple:
    """to_spec with divisibility + uniqueness guards: a logical axis whose
    dimension does not divide the mesh axis (e.g. 24 SSM heads over 16-way
    TP) or whose mesh axis is already taken degrades to replicated."""
    out, used = [], set()
    for i, name in enumerate(logical_axes):
        ax = rules.rules.get(name) if name else None
        if ax is None:
            out.append(None)
            continue
        flat = flat_axes(ax)
        if any(a in used for a in flat) or shape[i] % rules.axis_extent(ax):
            out.append(None)
            continue
        used.update(flat)
        out.append(ax)
    return tuple(out)


def param_spec(shape, logical_axes, rules: ShardingRules,
               fsdp: bool = True) -> tuple:
    """TP axis from the parameter's logical axes, then FSDP (ZeRO-3-style)
    over ``rules.fsdp_axes`` on the largest remaining divisible axis."""
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    mesh_axes = [None] * len(shape)
    used = set()
    for i, name in enumerate(logical_axes):
        ax = rules.rules.get(name) if name else None
        if ax is None:
            continue
        flat = flat_axes(ax)
        if any(a in used for a in flat):
            continue
        if shape[i] % rules.axis_extent(ax):
            continue  # unshardable (e.g. 2 kv heads over 16-way TP)
        mesh_axes[i] = ax
        used.update(flat)
    if fsdp and rules.fsdp_axes:
        free = [a for a in rules.fsdp_axes if a not in used]
        if free:
            size = rules.axis_extent(tuple(free))
            cands = [i for i in range(len(shape))
                     if mesh_axes[i] is None and shape[i] % size == 0]
            if cands:
                i = max(cands, key=lambda j: shape[j])
                mesh_axes[i] = free[0] if len(free) == 1 else tuple(free)
    return tuple(mesh_axes)


def is_axes(x) -> bool:
    """A leaf of an axes tree: a tuple of names and Nones."""
    return isinstance(x, tuple) and all(
        isinstance(e, (str, type(None))) for e in x)


def tree_param_specs(shapes, axes_tree, rules: ShardingRules,
                     fsdp: bool = True):
    """Zip a tree of shapes (or tensors) with its logical-axes tree into
    specs; the trees are nested dicts of the same keys."""
    if is_axes(axes_tree):
        shape = tuple(getattr(shapes, "shape", shapes))
        return param_spec(shape, axes_tree, rules, fsdp=fsdp)
    return {k: tree_param_specs(shapes[k], v, rules, fsdp=fsdp)
            for k, v in axes_tree.items()}


# ----------------------------------------------------------------------
# Specs on a DeviceMesh: placements, shards, DTensor leaves
# ----------------------------------------------------------------------

def _states(spec, mesh) -> list:
    """The spec as one state per mesh axis, in mesh order: the tensor dim
    the axis shards, or None (replicated)."""
    names = list(axis_sizes(mesh))
    st = [None] * len(names)
    for d, ax in enumerate(spec):
        flat = flat_axes(ax)
        if [names.index(a) for a in flat] != sorted(
                names.index(a) for a in flat):
            raise ValueError(f"spec entry {ax!r} is not in the mesh's axis "
                             f"order {tuple(names)}")
        for a in flat:
            st[names.index(a)] = d
    return st


def placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(i)`` on every
    mesh axis that splits tensor dim i (a dim over ``("pod", "data")`` is
    sharded on both, pod-major, as in JAX), else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if d is None else Shard(d)
            for d in _states(spec, mesh)]


def spec_of(t) -> tuple | None:
    """The spec of a DTensor (None for a plain tensor)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(t, DTensor):
        return None
    names = list(axis_sizes(t.device_mesh))
    out = [()] * t.ndim
    for name, pl in zip(names, t.placements):
        if isinstance(pl, Shard):
            out[pl.dim] = out[pl.dim] + (name,)
        elif not pl.is_replicate():
            raise ValueError(f"a {pl} leaf has no spec")
    return tuple(None if not e else (e[0] if len(e) == 1 else e)
                 for e in out)


def active() -> bool:
    """Whether a mesh can exist in this process: a ``torch.distributed``
    world is up (every DeviceMesh, so every DTensor, lives in one).  The
    single-device dispatch asks this first and skips every mesh check."""
    return dist.is_initialized()


def is_dtensor(t) -> bool:
    if not dist.is_initialized():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def local(t):
    """The local shard of a DTensor (the tensor itself otherwise)."""
    return t._local_tensor if is_dtensor(t) else t


def _coord(mesh, i: int) -> int:
    return mesh.get_coordinate()[i]


def _slice(x, mesh, axis: int, dim: int):
    n = tuple(mesh.shape)[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} shards")
    out = x.chunk(n, dim)[_coord(mesh, axis)].contiguous()
    # a shard starts on a 16-byte boundary, as a fresh allocation would
    # (the kernels' TMA and vector paths read the base's alignment)
    return out if out.data_ptr() % 16 == 0 else out.clone()


def _run(op: str, fn, out, inp):
    """One c10d collective ``fn(out, inp)``; counts the bytes sent."""
    COLLECTIVE_BYTES[op] += inp.numel() * inp.element_size()
    fn(out, inp)
    return out


def _gather(x, mesh, axis: int, dim: int):
    group = mesh.get_group(axis)
    n = tuple(mesh.shape)[axis]
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
    _run("all_gather_into_tensor",
         lambda o, i: dist.all_gather_into_tensor(o, i, group=group),
         out, src)
    return out.movedim(0, dim)


def _reduce_scatter(x, mesh, axis: int, dim: int):
    group = mesh.get_group(axis)
    n = tuple(mesh.shape)[axis]
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
    _run("reduce_scatter_tensor",
         lambda o, i: dist.reduce_scatter_tensor(o, i, group=group),
         out, src)
    return out.movedim(0, dim)


def _all_reduce(x, mesh, axis: int):
    group = mesh.get_group(axis)
    out = x.contiguous().clone()
    return _run("all_reduce",
                lambda o, i: dist.all_reduce(o, group=group), out, out)


PARTIAL = "partial"


def convert(x, mesh, src: list, dst: list):
    """Move a local shard between per-axis states (a tensor dim, None for
    replicated, or ``PARTIAL`` for a partial sum over that axis).  Gathers
    and reductions go minor axis first, slices and reduce-scatters major
    first, so a dim split over several axes keeps their major-first
    order."""
    for a in reversed(range(len(src))):
        s, d = src[a], dst[a]
        if s == d:
            continue
        if s == PARTIAL and d is None:
            x = _all_reduce(x, mesh, a)
        elif s is not None and s != PARTIAL:
            x = _gather(x, mesh, a, s)
    for a in range(len(src)):
        s, d = src[a], dst[a]
        if s == d or d is None:
            continue
        if s == PARTIAL:
            x = _reduce_scatter(x, mesh, a, d)
        elif d != PARTIAL:
            x = _slice(x, mesh, a, d)
    return x


class _Enter(torch.autograd.Function):
    """An operand (a plain global tensor or a DTensor) to its local shard
    at ``dst``.  The gradient arrives at ``dst`` but partial over the
    axes in ``partial`` (those that split the output and not this
    operand) and goes back to the operand's own layout."""

    @staticmethod
    def forward(ctx, t, mesh, src, dst, partial):
        ctx.mesh, ctx.src, ctx.dst, ctx.partial = mesh, src, dst, partial
        ctx.dt = (t.device_mesh, t.placements) if is_dtensor(t) else None
        return convert(local(t), mesh, src, dst)

    @staticmethod
    def backward(ctx, g):
        gdst = [PARTIAL if a in ctx.partial else d
                for a, d in enumerate(ctx.dst)]
        g = convert(g, ctx.mesh, gdst, ctx.src)
        if ctx.dt is not None:
            from torch.distributed.tensor import DTensor
            g = DTensor.from_local(g, ctx.dt[0], ctx.dt[1], run_check=False)
        return g, None, None, None, None


class _Leave(torch.autograd.Function):
    """A local output shard at ``src`` to the replicated global value."""

    @staticmethod
    def forward(ctx, x, mesh, src):
        ctx.mesh, ctx.src = mesh, src
        return convert(x, mesh, src, [None] * len(src))

    @staticmethod
    def backward(ctx, g):
        return convert(g, ctx.mesh, [None] * len(ctx.src), ctx.src), \
            None, None


def enter(t, spec, mesh, partial=frozenset()):
    """``t``'s local shard at ``spec`` (differentiable).  ``t`` is a plain
    tensor holding the global value, or a DTensor on ``mesh``."""
    if not is_dtensor(t):
        src = [None] * mesh.ndim
    else:
        src = _states(spec_of(t), mesh)
    dst = _states(spec, mesh)
    if src == dst and not partial and not is_dtensor(t):
        return t
    return _Enter.apply(t, mesh, src, dst, frozenset(partial))


def leave(x, spec, mesh):
    """A local output shard at ``spec`` back to the global value, a plain
    tensor replicated on every rank (differentiable)."""
    return _Leave.apply(x, mesh, _states(spec, mesh))


def full(t):
    """The global value of a DTensor on every rank (differentiable; the
    gradient of the replicated result is the local shard's), or ``t``."""
    if not is_dtensor(t):
        return t
    spec, mesh = spec_of(t), t.device_mesh
    return leave(enter(t, spec, mesh), spec, mesh)


def distribute(t, spec, mesh):
    """The DTensor of ``t`` (the same global value on every rank) at
    ``spec``: each rank keeps its slice, nothing is sent."""
    from torch.distributed.tensor import DTensor
    x = convert(t.detach(), mesh, [None] * mesh.ndim, _states(spec, mesh))
    out = DTensor.from_local(x, mesh, placements(spec, mesh),
                             run_check=False)
    return out.requires_grad_(t.requires_grad)


def zeros_like(t):
    """Zeros shaped and laid out like ``t`` (a DTensor's placements)."""
    if not is_dtensor(t):
        return torch.zeros_like(t)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(torch.zeros_like(local(t)), t.device_mesh,
                              t.placements, run_check=False)


def replication(t) -> int:
    """How many ranks hold each element of ``t`` (1 for a plain tensor)."""
    if not is_dtensor(t):
        return 1
    return math.prod(n for n, pl in zip(tuple(t.device_mesh.shape),
                                        t.placements) if pl.is_replicate())


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_writer() -> bool:
    """Whether this process writes shared files: rank 0, or no world."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    dist.barrier()


def all_reduce_world(x):
    """Sum a tensor over every rank of the default group."""
    out = x.contiguous().clone()
    return _run("all_reduce", lambda o, i: dist.all_reduce(o), out, out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A leaf's layout on a mesh (``jax.sharding.NamedSharding``'s
    counterpart)."""

    mesh: object
    spec: tuple


# ----------------------------------------------------------------------
# Activation annotations
# ----------------------------------------------------------------------

def shard(x, *logical_axes):
    """Annotate an activation with logical axes (no-op without a mesh).

    Under a mesh the rank is checked and the value goes on as it is.  The
    port's activations hold the global value on every rank: the per-shard
    work of its mesh is the contraction's (``core.lowering``), whose
    dispatch lays each operand out at its own plan's spec, so no layout is
    carried between contractions (ROADMAP queue 3).
    """
    r = current()
    if r.enabled and r.mesh is not None and len(logical_axes) != x.ndim:
        raise ValueError(
            f"shard() got {len(logical_axes)} axes for rank-{x.ndim} value")
    return x


# ----------------------------------------------------------------------
# Sanctioned collectives: the only raw all-to-all surface above
# core/lowering.  models/moe.py's expert dispatch calls this.
# ----------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """Exchange dim ``split`` for dim ``concat`` over one mesh axis: each
    rank sends chunk j of ``split`` to rank j and concatenates what it
    gets along ``concat``; the gradient is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split, concat):
        ctx.args = (mesh, axis, concat, split)
        return _all_to_all(x, mesh, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None, None


def _all_to_all(x, mesh, axis, split, concat):
    group = mesh.get_group(axis)
    n = tuple(mesh.shape)[axis]
    src = torch.cat(x.chunk(n, split), dim=0).contiguous() if split else \
        x.contiguous()
    # src is now n blocks along dim 0, block j for rank j
    out = torch.empty_like(src)
    _run("all_to_all_single",
         lambda o, i: dist.all_to_all_single(o, i, group=group), out, src)
    return torch.cat(out.chunk(n, 0), dim=concat)


@dataclasses.dataclass(frozen=True)
class BankShard:
    """A ``Plan.mesh`` binding for a contract on one rank's shard of a
    batched product ``factor`` times larger (the exchange's per-shard
    banks): it runs on this rank alone, on the kernel plan resolved at
    the whole batch (``core.lowering``), as a mesh dispatch's shards
    do."""

    factor: int


def expert_exchange(buf, params, fn):
    """All-to-all expert dispatch: exchange a slot-sharded ``(E, C, ...)``
    dispatch buffer against the expert axis, run ``fn`` on each shard's
    expert slab, and exchange the result back.

    ``buf`` holds the global buffer on every rank; rank r of the expert
    axis keeps its slots ``[r*C/P, (r+1)*C/P)`` (tokens live where they
    were routed from).  One all-to-all gives each rank ``(E/P, C, ...)``,
    every peer's slots for its experts, and ``fn(slab, local params,
    binding)`` runs the per-shard batched expert products on its experts'
    weights (``params``: a dict of per-expert tensors, experts leading,
    plain or DTensor).  The result goes back by the inverse all-to-all and
    is gathered over the slots, so the global result is exactly the
    unsharded ``fn(buf, params, False)``: the exchange is a pure
    permutation of slots.

    Degrades to a plain ``fn(buf, params, False)`` call when no
    expert-parallel axis is active or E/C do not divide it: the caller
    never branches.  ``fn``'s contracts bind ``Plan(mesh=binding)``: False
    (single-device) or a :class:`BankShard` (the slab's plan is the whole
    bank's, so each shard sums as the unsharded bank does).
    """
    r = current()
    ax = r.rules.get("experts") if r.enabled and r.mesh is not None \
        else None
    p = r.axis_extent(ax)
    e, c = buf.shape[0], buf.shape[1]
    if p <= 1 or e % p or c % p:
        return fn(buf, params, False)
    from repro_torch.runtime import faults as _faults
    _faults.maybe_inject(_faults.COLLECTIVE)
    if len(flat_axes(ax)) != 1:
        raise NotImplementedError(f"an expert axis over {ax!r}: the port "
                                  "exchanges over one mesh axis")
    mesh = r.mesh
    names = list(axis_sizes(mesh))
    a = names.index(flat_axes(ax)[0])
    slot_spec = (None, ax) + (None,) * (buf.ndim - 2)
    b = enter(buf, slot_spec, mesh)
    b = _AllToAll.apply(b, mesh, a, 0, 1)
    ps = {k: enter(v, (ax,) + (None,) * (v.ndim - 1), mesh)
          for k, v in params.items()}
    out = fn(b, ps, BankShard(p))
    out = _AllToAll.apply(out, mesh, a, 1, 0)
    return leave(out, slot_spec, mesh)
