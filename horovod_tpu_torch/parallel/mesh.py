"""The device mesh of the port: named axes over the world's ranks, each
axis a process group.

Counterpart of `horovod_tpu.parallel.mesh`. Where the JAX package lays
one controller's devices out on a `jax.sharding.Mesh` and lets GSPMD
place the arrays, the port is SPMD: every rank is a process that drives
one device (or, over gloo, shares one), holds its own block of the
data, and names the axis a collective runs over. `make_mesh` builds a
`torch.distributed.device_mesh.DeviceMesh` over the world's ranks with
the JAX package's five axes in its canonical outer-to-inner order
(``pipe, data, seq, expert, model``), one process group an axis; `use`
installs a mesh as the ambient one (a context variable) for the
collectives of `ops.collectives` and the sequence-parallel attention;
`shard_batch` cuts this rank's block out of a host batch.

The port covers the ``data``, ``seq`` and ``model`` axes: a mesh with
``pipe`` or ``expert`` > 1 raises, naming its later slice. The
placement helpers of tensor parallelism have their SPMD meaning:
`sharding` names a layout (`Sharding`), `place_with_specs` and
`put_like` return THIS rank's block of each full leaf, and `constrain`
is the identity (a layout is explicit in an SPMD program; there is no
partitioner to pin it for).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

AXIS_DATA = "data"
AXIS_SEQ = "seq"
AXIS_MODEL = "model"
AXIS_PIPE = "pipe"
AXIS_EXPERT = "expert"

# Outer -> inner (inner = the chattiest collectives on the closest ranks).
_CANONICAL_ORDER = (AXIS_PIPE, AXIS_DATA, AXIS_SEQ, AXIS_EXPERT, AXIS_MODEL)

# The axes of later slices of the port, and the slice each belongs to.
_LATER_AXES = {AXIS_PIPE: "pipeline parallelism",
               AXIS_EXPERT: "expert parallelism"}

_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "horovod_tpu_torch_mesh", default=None)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Requested degree of each parallelism axis.

    ``data=-1`` (default) absorbs all ranks not claimed by other axes.
    Axes of degree 1 are still present in the mesh, so code can always
    name every canonical axis."""

    data: int = -1
    seq: int = 1
    model: int = 1
    pipe: int = 1
    expert: int = 1

    def resolve(self, n_devices: int) -> "MeshSpec":
        fixed = {f.name: getattr(self, f.name)
                 for f in dataclasses.fields(self)}
        free = [k for k, v in fixed.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"at most one axis may be -1, got {free}")
        claimed = math.prod(v for v in fixed.values() if v != -1)
        if free:
            if n_devices % claimed:
                raise ValueError(
                    f"{n_devices} devices not divisible by the "
                    f"{claimed} claimed by {fixed}")
            fixed[free[0]] = n_devices // claimed
        elif claimed != n_devices:
            raise ValueError(
                f"mesh axes {fixed} need {claimed} devices, have "
                f"{n_devices}")
        return MeshSpec(**fixed)


def make_mesh(spec: Optional[MeshSpec] = None,
              devices: Optional[Sequence[int]] = None, *,
              device_type: str = "cuda", **axis_sizes: int):
    """A 5-axis `DeviceMesh` over the world's ranks::

        mesh = make_mesh(data=2, seq=2)      # 4 ranks

    Either a `MeshSpec` or axis sizes as keywords. ``devices``: the
    world's ranks in the order to lay out (default ``range(world)``;
    every rank of the world, each once). The grid is laid out in the
    canonical order (pipe, data, seq, expert, model), so the inner axes
    take neighbouring ranks. ``device_type`` is the mesh's device,
    ``"cuda"`` unless ``"cpu"`` is asked for. Each axis is one process
    group of the world's backend, created by the ranks on it only.
    Collective: every rank of the world calls it with the same
    arguments, after ``horovod_tpu_torch.init()`` (or any
    `torch.distributed.init_process_group`)."""
    from torch.distributed.device_mesh import DeviceMesh
    if spec is None:
        spec = MeshSpec(**axis_sizes)
    elif axis_sizes:
        raise ValueError("pass either spec or keyword axis sizes, not both")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be cuda|cpu, got "
                         f"{device_type!r}")
    for axis, what in _LATER_AXES.items():
        if getattr(spec, axis) > 1:
            raise NotImplementedError(
                f"a mesh with {axis}={getattr(spec, axis)} needs {what}, a "
                f"later slice of the PyTorch port (ROADMAP Queue A 5; the "
                f"port shards data, seq and model)")
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs the world's process group: call "
            "horovod_tpu_torch.init() (or "
            "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r)
                                                        for r in devices]
    spec = spec.resolve(len(ranks))
    if sorted(ranks) != list(range(world)):
        raise ValueError(f"devices must hold each of the world's {world} "
                         f"ranks once, got {ranks}")
    shape = tuple(getattr(spec, name) for name in _CANONICAL_ORDER)
    grid = torch.tensor(ranks, dtype=torch.int).reshape(shape)
    me = dist.get_rank()
    backend = dist.get_backend()
    lines = [_line(grid, me, ax) for ax in range(len(shape))]
    groups = [dist.new_group(line, backend=backend,
                             use_local_synchronization=True)
              for line in lines]
    for name, g, line in zip(_CANONICAL_ORDER, groups, lines):
        # Group rank == axis coordinate (the all-to-all's chunk order).
        if [dist.get_global_rank(g, i) for i in range(len(line))] != line:
            raise RuntimeError(f"axis {name}: group ranks out of "
                               f"coordinate order")
    return DeviceMesh.from_group(groups, device_type, mesh=grid,
                                 mesh_dim_names=_CANONICAL_ORDER)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> dict:
    """{axis name: size} of ``mesh`` (the JAX `Mesh.shape`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _line(grid: torch.Tensor, rank: int, ax: int) -> list:
    """The global ranks of ``rank``'s line along axis ``ax`` of
    ``grid``: the ranks that differ from it in that coordinate only, in
    coordinate order."""
    coord = [int(c) for c in (grid == rank).nonzero()[0]]
    return grid[tuple(slice(None) if i == ax else c
                      for i, c in enumerate(coord))].tolist()


def axis_ranks(name: str, mesh=None) -> list:
    """The global ranks along axis ``name`` through this rank, in
    coordinate order (the ambient mesh unless given)."""
    mesh = _bound(name, mesh)
    return _line(mesh.mesh, dist.get_rank(), mesh.mesh_dim_names.index(name))


def _bound(name: str, mesh=None):
    """``mesh`` (else the ambient one) when it has axis ``name``; an
    unbound axis name raises, as it does in the JAX package."""
    mesh = mesh if mesh is not None else abstract_mesh()
    if mesh is None or name not in mesh.mesh_dim_names:
        raise NameError(f"unbound axis name: {name} (no ambient mesh has "
                        f"it; call under horovod_tpu_torch.parallel.mesh."
                        f"use(mesh))")
    return mesh


def axis_group(name: str, mesh=None):
    """The process group of axis ``name`` through this rank."""
    return _bound(name, mesh).get_group(name)


def axis_size(name: str, mesh=None) -> int:
    """Size of axis ``name`` of the ambient mesh (or ``mesh``)."""
    mesh = _bound(name, mesh)
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(name: str, mesh=None) -> int:
    """This rank's coordinate on axis ``name`` (the `lax.axis_index`)."""
    return _bound(name, mesh).get_local_rank(name)


def ring_perms(axis_name: str):
    """(forward, backward) `ppermute` permutations for the axis ring:
    the neighbour exchange of every ring schedule (ring attention's K/V
    rotation)."""
    n = axis_size(axis_name)
    fwd = [(i, (i + 1) % n) for i in range(n)]
    bwd = [(i, (i - 1) % n) for i in range(n)]
    return fwd, bwd


@contextlib.contextmanager
def use(mesh):
    """Install ``mesh`` as the ambient mesh of this context."""
    token = _AMBIENT.set(mesh)
    try:
        yield mesh
    finally:
        _AMBIENT.reset(token)


def abstract_mesh():
    """The ambient mesh installed by `use`, or None off-mesh."""
    return _AMBIENT.get()


def seq_degree() -> int:
    """Size of the ambient mesh's ``seq`` axis; 1 off-mesh."""
    mesh = abstract_mesh()
    return 1 if mesh is None else axis_size(AXIS_SEQ, mesh)


def seq_offset(seq_len: int) -> int:
    """Global position of this rank's first sequence element: its
    ``seq`` coordinate times the local length ``seq_len`` under an
    ambient mesh, 0 off-mesh."""
    mesh = abstract_mesh()
    if mesh is None:
        return 0
    return axis_index(AXIS_SEQ, mesh) * seq_len


def safe_spec(mesh, spec, shape) -> tuple:
    """Degrade a partition spec (a tuple of axis names, tuples of names
    or None per dimension) to what ``mesh`` can shard on a concrete
    array of ``shape``: axes absent from the mesh are dropped, and so
    are axes whose size does not divide the dimension."""
    sizes = mesh_shape(mesh)
    spec = tuple(spec) if isinstance(spec, (tuple, list)) else (spec,)
    assert len(spec) <= len(shape), (
        f"spec {spec} has more entries than array rank {len(shape)} "
        f"(shape {shape})")

    def keep(entry, dim):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept, degree = [], 1
            for e in entry:
                if e in sizes and dim % (degree * sizes[e]) == 0:
                    kept.append(e)
                    degree *= sizes[e]
            return tuple(kept) if kept else None
        if entry in sizes and dim % sizes[entry] == 0:
            return entry
        return None

    return tuple(keep(s, d) for s, d in zip(spec, shape))


def _block(x, dim: int, axes: Sequence[str], mesh):
    """This rank's block of ``x`` along ``dim``, split over ``axes``
    (the first outermost), by the rank's coordinates on them."""
    n, idx = 1, 0
    for name in axes:
        size = axis_size(name, mesh)
        idx = idx * size + axis_index(name, mesh)
        n *= size
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {tuple(axes)} of {n} ranks")
    step = x.shape[dim] // n
    return x.narrow(dim, idx * step, step)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, batch, axes: Sequence[str] = (AXIS_DATA,),
                seq_axis: Optional[str] = AXIS_SEQ):
    """This rank's block of a host batch (a tensor, a numpy array, or a
    dict / list / tuple of them): dim 0 split over ``axes``, and dim 1
    over ``seq_axis`` (None: not split; an axis of size 1 splits
    nothing). The SPMD form of the JAX package's placement with
    ``P("data", "seq")``: the seq ranks of one data rank read the same
    rows, each its own columns. Returns contiguous tensors (views of
    the batch's rows are copied)."""
    def cut(x):
        x = torch.as_tensor(x)
        x = _block(x, 0, axes, mesh)
        if seq_axis is not None and x.ndim > 1:
            x = _block(x, 1, (seq_axis,), mesh)
        return x.contiguous()
    return _tree_map(cut, batch)


def replicate(mesh, tree):
    """Every tensor of ``tree`` as the mesh's first rank holds it, on
    every rank (a broadcast over the world; the SPMD form of placing a
    host tree replicated, as `broadcast_global_variables` does).
    Returns new tensors on each input's device."""
    root = int(mesh.mesh.reshape(-1)[0])

    def bcast(x):
        x = torch.as_tensor(x).detach().clone()
        if dist.get_world_size() > 1:
            dist.broadcast(x, src=root)
        return x
    return _tree_map(bcast, tree)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A layout over ``mesh``: one partition-spec entry per dimension (an
    axis name, a tuple of names, or None), the `NamedSharding` of the
    JAX package. `place_with_specs` and `put_like` read it."""

    mesh: object
    spec: tuple


def sharding(mesh, *spec) -> Sharding:
    """`Sharding(mesh, spec)` shorthand (the JAX ``sharding(mesh,
    *spec)``)."""
    return Sharding(mesh, tuple(spec))


def model_degree(mesh=None) -> int:
    """Size of the ``model`` axis of ``mesh`` (else the ambient mesh);
    1 off-mesh."""
    mesh = mesh if mesh is not None else abstract_mesh()
    return 1 if mesh is None else axis_size(AXIS_MODEL, mesh)


def _place(x, mesh, spec):
    """This rank's block of the full leaf ``x`` under ``spec``, degraded
    through `safe_spec` first: each dimension split over its axes (the
    first outermost) by this rank's coordinates on them. A leaf with no
    sharded dimension comes back as it is."""
    spec = safe_spec(mesh, spec, tuple(x.shape))
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        x = _block(x, dim, axes, mesh)
    return x.contiguous()


def place_with_specs(mesh, tree, specs):
    """This rank's block of every full leaf of ``tree`` (a tensor, or a
    dict / list / tuple of them) under the matching spec of ``specs``
    (a tuple of entries per leaf, or a `Sharding`), each degraded
    through `safe_spec`: a dimension the axis does not divide stays
    whole. The SPMD form of committing a host tree onto the mesh: each
    rank keeps only its block."""
    def go(x, s):
        if isinstance(x, dict):
            return {k: go(v, s[k]) for k, v in x.items()}
        if isinstance(x, (list, tuple)) and not _is_spec(s):
            return type(x)(go(v, t) for v, t in zip(x, s))
        if isinstance(s, Sharding):
            s = s.spec
        return _place(torch.as_tensor(x), mesh, s)
    return go(tree, specs)


def _is_spec(s) -> bool:
    return isinstance(s, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in s)


def put_like(x, ref):
    """``x`` (a full leaf) cut to ``ref``'s layout: ``ref`` is a
    `Sharding`, or a tensor carrying one as ``ref.sharding``; anything
    else keeps ``x`` whole. Lands on ``ref``'s device when ``ref`` is a
    tensor."""
    sh = ref if isinstance(ref, Sharding) else getattr(ref, "sharding",
                                                       None)
    x = torch.as_tensor(x)
    if isinstance(sh, Sharding):
        x = _place(x, sh.mesh, sh.spec)
    if isinstance(ref, torch.Tensor):
        x = x.to(ref.device)
    return x


def constrain(x, *spec):
    """The identity. In the JAX package this pins an intermediate's
    layout for the GSPMD partitioner; in the port every rank holds its
    own block explicitly, so there is nothing to pin."""
    del spec
    return x
