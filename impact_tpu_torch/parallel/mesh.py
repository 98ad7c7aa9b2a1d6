"""Device meshes and state shardings (port of ``impact_tpu/parallel/mesh.py``).

Axes, as the reference's:

* ``objects``: the voxel-object pool (grids, meshes, probes) splits into
  equal blocks of slots, one block per coordinate;
* ``space``: the voxel grids' x axis splits into equal slabs (the halo
  exchange of ``halo.py`` reads across them).

A sharded state is this rank's block of each leaf beside a tree of
``torch.distributed.tensor`` placements (``sim_state_shardings``): plain
tensors, so the engine's functions run on them unchanged, and every
collective goes through the mesh's :class:`~.comm.Comm`.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from ..voxel.collision import PROBE_BLOCK
from .comm import Comm, resolve_backend

AXES = ("objects", "space")


class DeviceMesh:
    """A 2-D ("objects", "space") mesh of ranks: the torch
    ``DeviceMesh`` that names its process groups, the device the rank's
    tensors live on, the transport and the rank's :class:`Comm`."""

    def __init__(self, torch_mesh, device, backend: str):
        self.torch_mesh = torch_mesh
        self.device = torch.device(device)
        self.backend = backend
        self.axis_names = tuple(torch_mesh.mesh_dim_names)
        self.shape = tuple(torch_mesh.mesh.shape)
        coord = torch_mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        self.coordinate = tuple(coord)
        self.comm = Comm({name: (torch_mesh.get_group(name), c, n)
                          for name, c, n in zip(self.axis_names, coord, self.shape)},
                         self.device, backend)

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]


def make_device_mesh(n_objects_axis: int | None = None, n_space_axis: int = 1, device="cuda",
                     backend: str | None = None, ranks=None) -> DeviceMesh:
    """A 2-D ("objects", "space") mesh over the ranks of the process group
    (or over ``ranks``, a subset of them, in row-major order; every rank of
    the group must call this, those outside the mesh get None). Starts the
    process group from the environment (``torchrun``'s variables) if none
    is running. ``backend`` as :func:`~.comm.resolve_backend`; a running
    group must already use it."""
    from torch.distributed.device_mesh import DeviceMesh as TorchMesh, init_device_mesh

    dev = torch.device(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", "1"))
        dist.init_process_group(resolve_backend(dev, backend, world))
    world = dist.get_world_size()
    members = list(range(world)) if ranks is None else [int(r) for r in ranks]
    n = len(members)
    chosen = resolve_backend(dev, backend, n)
    running = dist.get_backend()
    if running != chosen:
        raise ValueError(f"the process group runs {running}, but {dev.type} tensors on {n} "
                         f"ranks need {chosen}")
    if n_objects_axis is None:
        n_objects_axis = n // n_space_axis
    if n_objects_axis * n_space_axis != n:
        raise ValueError(f"mesh {n_objects_axis} x {n_space_axis} does not cover {n} ranks")
    # the mesh's groups carry the transport's tensors: host tensors under gloo
    mesh_type = "cuda" if chosen == "nccl" else "cpu"
    if ranks is None:
        tm = init_device_mesh(mesh_type, (n_objects_axis, n_space_axis), mesh_dim_names=AXES)
    else:
        tm = TorchMesh(mesh_type, torch.tensor(members).reshape(n_objects_axis, n_space_axis),
                       mesh_dim_names=AXES)
    if tm.get_coordinate() is None:
        return None
    return DeviceMesh(tm, dev, chosen)


class Slab(NamedTuple):
    """This rank's slab of the voxel grids' x axis: planes [x0, x0+gx) of
    G, the ``index``-th of ``count`` along the mesh's ``space`` axis."""

    x0: int
    gx: int
    g: int
    index: int
    count: int


def check_slab_constraints(g: int, n_space: int, merge_levels: int):
    """Raise ValueError unless G³ grids split into ``n_space`` slabs along
    x that the sharded step can mesh and probe on their own: G a multiple
    of the axis, each slab a multiple of the probe block (4³ probe blocks
    stay inside a slab) and of 2^merge_levels (merged quad blocks stay
    inside a slab). GSPMD splits any shape; the port does not (ROADMAP.md,
    Queue 3)."""
    if g % n_space:
        raise ValueError(f"slab constraint: G = {g} does not divide over a space axis of "
                         f"{n_space}")
    gx = g // n_space
    if gx % PROBE_BLOCK:
        raise ValueError(f"slab constraint: a slab of {gx} x planes is not a multiple of the "
                         f"probe block ({PROBE_BLOCK})")
    if gx % (1 << merge_levels):
        raise ValueError(f"slab constraint: a slab of {gx} x planes is not a multiple of "
                         f"2**mesh_merge_levels ({1 << merge_levels})")


def grid_slab(mesh: DeviceMesh, g: int) -> Slab:
    """This rank's slab of G³ grids, from its ``space`` coordinate."""
    n = mesh.size("space")
    i = mesh.comm.coordinate("space")
    return Slab(i * (g // n), g // n, g, i, n)


# --- placements ---------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn, tree, prefix: str = ""):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``; paths are the
    reference's stringified field paths ("voxels/sdf")."""
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), f"{prefix}{f}/")
                            for f in tree._fields))
    return fn(prefix[:-1], tree)


def leaves_with_path(tree, prefix: str = ""):
    """[(path, leaf)] in field order."""
    if _is_namedtuple(tree):
        out = []
        for f in tree._fields:
            out += leaves_with_path(getattr(tree, f), f"{prefix}{f}/")
        return out
    return [(prefix[:-1], tree)]


REPLICATED = (Replicate(), Replicate())
OBJECTS = (Shard(0), Replicate())
OBJECTS_SPACE = (Shard(0), Shard(1))


def placement_for_path(name: str, leaf):
    """The reference's path rules (mesh.py:40-73): voxel grids shard over
    objects × space, the other voxel leaves and every mesh and probe leaf
    over objects; the rest (bodies, contacts, render state, the fracture
    generator) is replicated."""
    if "voxels/sdf" in name or "voxels/vtype" in name:
        return OBJECTS_SPACE
    if name.startswith("voxels/") and getattr(leaf, "ndim", 0) >= 1:
        return OBJECTS
    if name.startswith("meshes/") or name.startswith("probes/"):
        return OBJECTS
    return REPLICATED


def sim_state_shardings(mesh: DeviceMesh, sim):
    """The placements of each leaf of a SimState on ``mesh``: a tree of
    the SimState's structure whose leaves are (objects-axis, space-axis)
    placement pairs."""
    return map_with_path(placement_for_path, sim)


def _block(t, dim: int, n: int, i: int, what: str, axis: str):
    if t.dim() <= dim:
        raise ValueError(f"{what}: placed on the {axis} axis along dim {dim}, but it has rank "
                         f"{t.dim()}")
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"{what}: dim {dim} of {size} does not divide over {n} ranks")
    b = size // n
    return t.narrow(dim, i * b, b)


def shard_tensor(mesh: DeviceMesh, t, placements, what: str = "tensor"):
    """This rank's block of the whole tensor ``t`` under ``placements``.
    Raises ValueError if a sharded dim does not divide over its axis, or if
    ``t`` lacks it (a 0-d leaf placed on an axis: the reference's
    ``device_put`` refuses it alike)."""
    for axis, p in zip(mesh.axis_names, placements):
        if isinstance(p, Shard):
            t = _block(t, p.dim, mesh.size(axis), mesh.comm.coordinate(axis), what, axis)
    return t.clone()


def shard_sim_state(mesh: DeviceMesh, sim):
    """This rank's shard of a whole SimState (every rank holds the whole
    state, e.g. from the same ``compile_scene``). Raises ValueError, naming
    the leaf, if a sharded dim does not divide evenly over its axis or a
    leaf lacks it: a chunked state's 0-d overflow counters
    (``meshes/n_dropped_verts``, ...) under the ``meshes/`` rule, as the
    reference's ``shard_sim_state`` refuses them."""
    shardings = sim_state_shardings(mesh, sim)
    flat = dict(leaves_with_path(shardings))

    def shard(path, leaf):
        if not isinstance(leaf, torch.Tensor) or flat[path] == REPLICATED:
            return leaf
        return shard_tensor(mesh, leaf, flat[path], path)

    return map_with_path(shard, sim)


def gather_tensor(mesh: DeviceMesh, t, placements):
    """The whole tensor from this rank's block (on every rank)."""
    for axis, p in reversed(list(zip(mesh.axis_names, placements))):
        if isinstance(p, Shard):
            t = mesh.comm.all_gather(t.movedim(p.dim, 0).contiguous(), axis).movedim(0, p.dim)
    return t.contiguous()


def gather_sim_state(mesh: DeviceMesh, sim):
    """The whole SimState from the ranks' shards, on every rank (for checks
    and for rendering on one rank)."""
    flat = dict(leaves_with_path(sim_state_shardings(mesh, sim)))

    def gather(path, leaf):
        if not isinstance(leaf, torch.Tensor) or flat[path] == REPLICATED:
            return leaf
        return gather_tensor(mesh, leaf, flat[path])

    return map_with_path(gather, sim)


def body_shardings(mesh: DeviceMesh, bodies):
    """The placements of each leaf of a BodyState split over the ``objects``
    axis (``tests/test_parallel.py:220-229``'s rule): ``OBJECTS`` for a leaf
    with a leading dim of N, ``REPLICATED`` for any other."""
    n = bodies.n

    def placement(path, leaf):
        return OBJECTS if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == n else REPLICATED

    return map_with_path(placement, bodies)


def shard_bodies(mesh: DeviceMesh, bodies):
    """This rank's block of N/n_objects rows of every [N] leaf of a whole
    BodyState (replicated over ``space``). Raises ValueError if N does not
    divide over the ``objects`` axis."""
    flat = dict(leaves_with_path(body_shardings(mesh, bodies)))
    return map_with_path(lambda path, leaf: shard_tensor(mesh, leaf, flat[path], path)
                         if flat[path] != REPLICATED else leaf, bodies)


def gather_bodies(mesh: DeviceMesh, local):
    """The whole BodyState from the ranks' blocks, on every rank."""
    flat = dict(leaves_with_path(body_shardings(mesh, local)))
    return map_with_path(lambda path, leaf: gather_tensor(mesh, leaf, flat[path])
                         if flat[path] != REPLICATED else leaf, local)


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` as the mesh's first rank holds it, on every
    rank (broadcast along each axis from coordinate 0)."""

    def rep(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return leaf
        for axis in mesh.axis_names:
            leaf = mesh.comm.broadcast(leaf, 0, axis)
        return leaf

    return map_with_path(rep, tree)
