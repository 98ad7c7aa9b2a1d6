"""The engine step sharded over the voxel-object pool: the decomposition
that GSPMD derives for the reference's ``jax.jit(step, in_shardings=...)``
(``__graft_entry__.py:109-117``), written out.

Each rank holds its block of the ``objects`` axis: slots [lo, hi) of the
voxel grids and the other voxel leaves, the meshes and the probes
(``mesh.sim_state_shardings``). Bodies, the solver cache, the render state
and the fracture generator are replicated. Per step:

* the per-object vectors (``VECTOR_FIELDS``, [O] or [O,3]) are gathered
  once, and kept up to date on every rank through the stages: the step's
  decisions read them, so every rank takes the same branch;
* physics runs replicated on every rank. Its voxel contacts: the probes are
  gathered once; each rank emits the plane and sphere contacts of its own
  objects and the pair contacts whose sampled object B it owns (B's grid is
  read only where it lives), compacts them, and the ranks' buffers are
  gathered and merged by key into the unsharded step's very buffer. On the
  card the solve's ``index_add_`` sums are not bitwise repeatable, so rank
  0's physics state is broadcast after the solve to keep the replicas equal;
* absorption carves each rank's own objects (the gate's ranking is global);
* a fracture event or a split candidate: its owner broadcasts the source
  object's grids (and, for a split, its labels, computed on the owner);
  every rank runs the unsharded function on a small pool of the source and
  the event's free slots, and keeps the rows that land in its own slots;
  every rank draws the event's uniforms, so the generators stay equal;
* the dirty sync: owners compute the new body rows and origins of their
  dirty objects and re-mesh them; the rows are gathered and applied in
  slot order on every rank.

With a ``space`` axis, the voxel grids are also split along x: each rank
of an objects-axis row holds its slab [O/n_o, G/n_s, G, G] of the row's
objects (``mesh.Slab``), every other object-axis leaf whole for the row.
The stencils read their neighbour planes through the halo exchange, and
the per-object results are combined over the row:

* the pair samples of the voxel contacts: each slab samples those whose
  lower corner plane it holds (the right halo plane completes the cells),
  and one exact sum over the row gives every rank the whole sample set;
* absorption carves each slab; ``mesh_dirty``/``split_pending`` are OR-ed
  over the row;
* the inertia sync sums the slabs' partial sums over the row (in another
  order than one sum over the grid: bodies agree to rounding);
* the remesh meshes each slab with two right halo planes and combines the
  slabs' compacted pieces into the whole mesh (``compact_mesh_slab``); the
  probes take the occupancy halo and are gathered over the row;
* a split candidate is labelled slab by slab through the labels kernel and
  the face label pairs are resolved over the row
  (``connected_component_labels_slab``);
* an event gathers the source's slabs over its row: the one grid-sized
  move, only on an event (``step.event_bytes``); each rank keeps the slabs
  of its own slots.

A step without an event moves no grid between ranks and no slab: only
planes, pieces of meshes and per-object vectors. Chunked mode raises, as
the reference's sharding does (ROADMAP.md, Queue 3, "Chunked states under
sharding").
"""

from __future__ import annotations

import torch

from ..physics.collision import ContactBuffer, compact_contacts
from ..physics.step import physics_step
from ..runtime.engine import (
    EngineParams,
    SimState,
    _free_slots,
    _inherit_fragment_motion,
    _put,
    apply_distance_rules,
    event_slots,
    fracture_candidates,
    gather_objects,
    impact_point_local,
    put_body_rows,
    remesh_objects,
    step_plan,
    voxel_body_rows,
)
from ..runtime.engine import MeshSlab
from ..voxel.collision import VoxelProbes, extract_probes, merge_contact_buffers, stable_topk, \
    voxel_contacts
from ..voxel.encoding import far_value
from ..voxel.interaction import (
    _absorber_overlap_mask,
    _apply_absorption_dense,
    connected_component_labels,
    connected_component_labels_slab,
    fracture_object,
    split_off_disconnected_regions,
)
from ..voxel.mesh import CompactMesh
from ..voxel.object import VoxelObjectPool, occupancy
from .halo import exchange_halo_x
from .mesh import DeviceMesh, check_slab_constraints, grid_slab

# the per-object vectors every rank holds whole during a step
VECTOR_FIELDS = ("alive", "body_index", "voxel_extent", "origin", "mesh_dirty", "split_pending",
                 "casts_shadows")


def _put_rows(full, to, new):
    """``full`` with rows ``to`` replaced by ``new``; a ``to`` of
    ``len(full)`` writes a spare row that is dropped (where the event or the
    gate has no row for this rank)."""
    return torch.cat([full, full[:1]]).index_copy(0, to, new.to(full.dtype))[:full.shape[0]]


def broadcast_tree(comm, tree, src: int, axis: str = "objects"):
    """Every tensor of a NamedTuple tree as the rank at ``src`` holds it, in
    one broadcast."""
    leaves = []

    def collect(t):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            for x in t:
                collect(x)
        elif isinstance(t, torch.Tensor):
            leaves.append(t)

    collect(tree)
    got = comm.broadcast_rows([t.reshape(1, -1) for t in leaves], src, axis)
    it = iter(g.reshape(t.shape) for g, t in zip(got, leaves))

    def fill(t):
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(fill(x) for x in t))
        return next(it) if isinstance(t, torch.Tensor) else t

    return fill(tree)


def ordered_sum(parts):
    """``parts`` [S, ...] summed in order: ((p0 + p1) + p2) + ..."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# --- the row: the ranks along ``space`` that hold the slabs of the same objects ----


def row_gather(mesh: DeviceMesh, t):
    """[S, ...]: the row's ``t`` in slab order."""
    return mesh.comm.all_gather(t, "space").reshape(mesh.size("space"), *t.shape)


def row_combine(mesh: DeviceMesh, t):
    """The row's ``t`` of which at most one is not 0 in each element, summed
    as i32 words: exactly that one (−0.0 and NaNs included)."""
    words = t.contiguous().view(torch.int32) if t.dtype == torch.float32 else t
    out = mesh.comm.all_reduce(words.reshape(-1), "space").reshape(words.shape)
    return out.view(torch.float32) if t.dtype == torch.float32 else out


def slab_labels(mesh: DeviceMesh, slab, occ):
    """The whole grids' labels of this rank's slabs ``occ`` [K,gx,G,G] of
    the row's objects (``connected_component_labels_slab``)."""
    return connected_component_labels_slab(
        occ, slab.x0, lambda t: exchange_halo_x(t, mesh, fill=-1, left=1, right=0)[0],
        lambda t: row_gather(mesh, t))


def slab_meshes_and_probes(mesh: DeviceMesh, slab, sub: VoxelObjectPool, response,
                           merge_levels: int, vert_cap: int, tri_cap: int, material_table):
    """The whole meshes and probes of a sub-pool of this rank's slabs of the
    row's objects, on every rank of the row: one halo exchange of sdf and
    vtype planes (one left, two right) feeds both; the meshes combine the
    slabs' compacted pieces (``compact_mesh_slab``), the probes are the
    slabs' gathered side by side."""
    far = far_value(sub.sdf.dtype, 1.0)
    (l_sdf, _), (r_sdf, r_vt) = exchange_halo_x([sub.sdf, sub.vtype], mesh, fill=[far, 0],
                                               left=1, right=2)
    ms = MeshSlab(slab.x0, slab.index, slab.count, r_sdf, r_vt, lambda t: row_gather(mesh, t),
                  lambda t: row_combine(mesh, t))
    meshes = remesh_objects(sub, merge_levels, vert_cap, tri_cap, material_table, ms)
    halo = tuple(occupancy(sub._replace(sdf=p)) for p in (l_sdf, r_sdf[:, :1]))
    pr = extract_probes(sub, response, slab.x0, halo)
    k = pr.active.shape[0]
    got = mesh.comm.all_gather_rows([pr.active, pr.pos_local], "space")
    whole = [t.reshape(slab.count, k, *t.shape[1:]).transpose(0, 1).reshape(k, -1, *t.shape[2:])
             for t in got]
    return meshes, VoxelProbes(whole[0], whole[1],
                               response[:, None, :].expand(k, whole[0].shape[1], 3))


def make_sharded_engine_step(params: EngineParams, config, mesh: DeviceMesh, mesh_vert_cap: int,
                             mesh_tri_cap: int, enable_voxel_contacts: bool = True,
                             enable_absorption: bool = True, enable_splitting: bool = True,
                             enable_fracturing: bool = True, fracture_uniforms=None):
    """The engine step ``step(local_sim) -> local_sim`` of
    ``runtime.engine.make_engine_step`` (same signature and feature flags,
    plus the mesh) over a state sharded as ``mesh.sim_state_shardings``:
    ``params`` whole on every rank, the state this rank's shard
    (``shard_sim_state``). Its gathered result equals the unsharded step's
    (``gather_sim_state``); with a ``space`` axis, bodies (and the grid
    origins and probe positions, which follow the COM) to rounding.
    ``step.host_syncs`` counts the device reads of its branches, one per
    decision as the unsharded step's; ``step.event_bytes`` the bytes of
    the events' grid moves."""
    tc = config.tpu
    if tc.chunked_remesh:
        raise ValueError("chunked mode (tpu.chunked_remesh) is refused under sharding, as the "
                         "reference refuses it (ROADMAP.md, Queue 3: chunked states under "
                         "sharding)")
    comm = mesh.comm
    n_ranks, me = mesh.size("objects"), comm.coordinate("objects")
    (dt, n_substeps, solver_cfg, max_contacts, o_max, remesh_budget, impact_cfg, n_seeds,
     n_events, n_split_objs, n_split_regions, draw, absorb, rules) = step_plan(
        params, config, enable_absorption, enable_fracturing, fracture_uniforms)
    if o_max % n_ranks:
        raise ValueError(f"{o_max} object slots do not divide over {n_ranks} ranks")
    g = tc.voxel_grid_size
    split_x = mesh.size("space") > 1
    if split_x:
        check_slab_constraints(g, mesh.size("space"), tc.mesh_merge_levels)
    slab = grid_slab(mesh, g)
    x0, gx = slab.x0, slab.gx
    o_loc = o_max // n_ranks
    lo, hi = me * o_loc, (me + 1) * o_loc
    dev = mesh.device
    gate_cap = min(tc.absorption_gate_cap, o_max)

    def host(t):
        step.host_syncs += 1
        return t.tolist()

    def owner(slot: int) -> int:
        return slot // o_loc

    def row_sum(t):
        """The row's ``t`` summed in slab order, the same on every rank and
        in every run."""
        return ordered_sum(row_gather(mesh, t))

    def row_any(t):
        return comm.all_reduce(t.to(torch.uint8), "space", "max").bool()

    def whole_x(t):
        """The row's slabs [K,gx,...] side by side: [K,G,...]."""
        return torch.cat(list(row_gather(mesh, t)), dim=1)

    def gathered(pool: VoxelObjectPool) -> VoxelObjectPool:
        """The step's view: the pool with its per-object vectors gathered
        whole; its grids stay this rank's block."""
        vecs = comm.all_gather_rows([getattr(pool, f) for f in VECTOR_FIELDS])
        return pool._replace(**dict(zip(VECTOR_FIELDS, vecs)))

    def local(view: VoxelObjectPool) -> VoxelObjectPool:
        """The rank's block of the view."""
        return view._replace(**{f: getattr(view, f)[lo:hi] for f in VECTOR_FIELDS})

    def merged_contacts(vc: ContactBuffer) -> ContactBuffer:
        """The ranks' compacted buffers merged by key into the unsharded
        buffer: every active key is unique, and the unsharded compaction
        keeps the lowest ``max_contacts`` of them in key order."""
        g = ContactBuffer(*comm.all_gather_rows(list(vc)))
        order = torch.sort(g.key, stable=True)[1]
        g = ContactBuffer(*(f[order] for f in g))
        return compact_contacts(g.key, g.active, g.body_a, g.body_b, g.position, g.normal,
                                g.depth, g.response, max_contacts)

    def source_rows(view, slot: int, extra=()):
        """Object ``slot``'s whole grids (and ``extra`` slab rows its owner
        row computed), broadcast from its owner and gathered over the row."""
        src = owner(slot)
        if src == me:
            rows = [view.sdf[slot - lo:slot - lo + 1], view.vtype[slot - lo:slot - lo + 1],
                    *extra]
        else:
            g = view.sdf.shape[1:]
            rows = [torch.empty_like(view.sdf[:1]), torch.empty_like(view.vtype[:1]),
                    *(torch.empty((1, *g), dtype=torch.int32, device=dev) for _ in extra)]
        rows = comm.broadcast_rows(rows, src)
        step.event_bytes += sum(r.numel() * r.element_size() for r in rows) * (n_ranks > 1)
        if split_x:
            rows = [whole_x(r) for r in rows]
            step.event_bytes += sum(r.numel() * r.element_size() for r in rows)
        return rows

    def embed(block):
        """Slab rows [n,gx,G,G] at their x planes of zero [n,G,G,G] grids."""
        if not split_x:
            return block
        return torch.nn.functional.pad(block, (0, 0, 0, 0, x0, g - x0 - gx))

    def event_pool(view, slots, sdf, vtype):
        """A pool of the event's rows: ``slots`` [n] (slot 0 the source, −1 =
        none), with their vectors, the source's whole grids and this rank's
        slabs of its own slots at their planes (zeros elsewhere and for the
        others' slots, whose rows only their owners keep)."""
        gslot = torch.clamp(slots, min=0)
        mine = (slots >= lo) & (slots < hi)
        li = torch.clamp(slots - lo, 0, o_loc - 1)

        def grid(block, src):
            rows = torch.where(mine[:, None, None, None], block[li],
                               torch.zeros((), dtype=block.dtype, device=dev))
            return torch.cat([src, embed(rows[1:])])

        return view._replace(sdf=grid(view.sdf, sdf), vtype=grid(view.vtype, vtype),
                             **{f: getattr(view, f)[gslot] for f in VECTOR_FIELDS})

    def event_free(slots):
        """The event pool's indices of the free ``slots`` (−1 kept)."""
        ar = torch.arange(1, slots.shape[0] + 1, device=dev)
        return torch.where(slots >= 0, ar, -1)

    def write_rows(view, slots, rows: VoxelObjectPool):
        """The view with the event pool's ``rows`` written back: vectors at
        every slot, grids (this rank's slabs) at this rank's slots."""
        dest = torch.where(slots >= 0, slots, o_max)
        mine = (slots >= lo) & (slots < hi)
        dest_l = torch.where(mine, slots - lo, o_loc)
        return view._replace(sdf=_put_rows(view.sdf, dest_l, rows.sdf[:, x0:x0 + gx]),
                             vtype=_put_rows(view.vtype, dest_l, rows.vtype[:, x0:x0 + gx]),
                             **{f: _put_rows(getattr(view, f), dest, getattr(rows, f))
                                for f in VECTOR_FIELDS})

    def absorption(phys, view):
        """The object-gated (or dense) carve of this rank's objects (its
        slabs of them); the gate ranks the whole pool's overlapping
        objects."""
        b, absorbers = phys.bodies, params.absorbers
        pool = local(view)
        if gate_cap < o_max:
            hit = _absorber_overlap_mask(view, absorbers, b.position, b.orientation)
            order = torch.argsort((~hit).to(torch.uint8), stable=True)[:gate_cap]
            sel = hit[order] & (order >= lo) & (order < hi)
            rows = torch.clamp(order - lo, 0, o_loc - 1)
            sub = _apply_absorption_dense(gather_objects(pool, rows), absorbers, b.position,
                                          b.orientation, x0)
            dest = torch.where(sel, rows, o_loc)
            pool = pool._replace(**{f: _put_rows(getattr(pool, f), dest, getattr(sub, f))
                                    for f in ("sdf", "mesh_dirty", "split_pending")})
        else:
            pool = _apply_absorption_dense(pool, absorbers, b.position, b.orientation, x0)
        if split_x:
            flags = row_any(torch.stack([pool.mesh_dirty, pool.split_pending]))
            pool = pool._replace(mesh_dirty=flags[0], split_pending=flags[1])
        return gathered(pool)

    def maybe_fracture(phys, view, gen):
        """Up to ``n_events`` fracture events (ref: fracturing.rs:508)."""
        top_obj, ranked, best_contact = fracture_candidates(phys, view, params, n_events)
        free_all = _free_slots(view.alive)
        valid, targets = host(torch.stack([torch.isfinite(ranked[top_obj]).long(), top_obj]))
        for e in range(n_events):
            if not valid[e]:
                continue
            target = top_obj[e]
            free = event_slots(free_all, e, n_seeds - 1)
            tb = view.body_index[target]
            impact_local = impact_point_local(phys, best_contact[target], tb)
            uniforms = draw(gen, n_seeds)  # every rank draws: the generators stay equal
            sdf, vtype = source_rows(view, targets[e])
            slots = torch.cat([target[None], free])
            rows = fracture_object(event_pool(view, slots, sdf, vtype), 0, impact_local,
                                   uniforms, event_free(free), params.fracture_radius[target],
                                   n_seeds, impact_cfg)
            new = write_rows(view, slots, rows)
            # fracture_object marks every dirty, alive object split-pending
            new = new._replace(split_pending=new.split_pending | (new.mesh_dirty & new.alive))
            phys = _inherit_fragment_motion(phys, new, tb, new.alive & ~view.alive)
            view = new
        return phys, view

    def maybe_split(phys, view):
        """Up to ``n_split_objs`` split candidates, ``n_split_regions``
        regions each (ref: extraction.rs:78); each candidate is labelled on
        its owner row (slab by slab with a space axis)."""
        candidates = view.split_pending & view.alive
        cand_objs = stable_topk(candidates.to(torch.int32), n_split_objs)
        free_all = _free_slots(view.alive)
        flags, cands = host(torch.stack([candidates[cand_objs].long(), cand_objs]))
        valid = [e for e in range(n_split_objs) if flags[e]]
        if not valid:
            return phys, view
        mine = [e for e in valid if owner(cands[e]) == me]
        labels = {}
        if mine:
            objs = torch.tensor([cands[e] - lo for e in mine], device=dev)
            occ = occupancy(local(view))[objs]
            if split_x:
                lab = slab_labels(mesh, slab, occ)
            else:
                lab = connected_component_labels(occ).to(torch.int32)
            labels = {e: lab[k:k + 1] for k, e in enumerate(mine)}
        for e in valid:
            obj = cand_objs[e]
            sdf, vtype, lab = source_rows(view, cands[e], (labels.get(e),))
            free = event_slots(free_all, e, n_split_regions)
            slots = torch.cat([obj[None], free])
            rows, _, _ = split_off_disconnected_regions(event_pool(view, slots, sdf, vtype), 0,
                                                        event_free(free), lab[0])
            new = write_rows(view, slots, rows)
            phys = _inherit_fragment_motion(phys, new, view.body_index[obj],
                                            new.alive & ~view.alive)
            view = new
        return phys, view

    def remesh_and_probe(sub, idx_own):
        """The meshes and probes of the own sub-pool ``sub``."""
        resp = params.voxel_response[idx_own]
        if split_x:
            return slab_meshes_and_probes(mesh, slab, sub, resp, tc.mesh_merge_levels,
                                          mesh_vert_cap, mesh_tri_cap, params.material_table)
        return (remesh_objects(sub, tc.mesh_merge_levels, mesh_vert_cap, mesh_tri_cap,
                               params.material_table),
                extract_probes(sub, resp))

    def sync_dirty(phys, view, meshes, probes):
        """The inertia/COM sync, remesh and probe refresh of up to
        ``remesh_budget`` dirty objects, lowest slots first: owners compute,
        the body rows and origins are gathered. Each rank computes the rows
        on a batch of the unsharded step's shape (its own objects at their
        places, its other rows' results dropped), so that the card's
        reductions sum each object as the unsharded step does."""
        idx = torch.nonzero(view.mesh_dirty).flatten()[:remesh_budget]
        slots = idx.tolist()  # the decision's one read
        step.host_syncs += 1
        if not slots:
            return phys, view, meshes, probes
        k = len(slots)
        mine = (idx >= lo) & (idx < hi)
        sub = gather_objects(local(view), torch.clamp(idx - lo, 0, o_loc - 1))
        rows, origin = voxel_body_rows(phys, sub, params.type_density,
                                       torch.ones(k, dtype=torch.bool, device=dev),
                                       x0, row_sum if split_x else None)
        bufs = [torch.where(mine.reshape((k,) + (1,) * (r.ndim - 1)), r,
                            torch.zeros((), dtype=r.dtype, device=dev)) for r in (*rows, origin)]
        got = comm.all_gather_rows(bufs)
        pick = (idx // o_loc) * k + torch.arange(k, device=dev)  # each row from its owner
        got = [g[pick] for g in got]
        phys = put_body_rows(phys, view.body_index[idx], got[:-1])
        view = view._replace(origin=_put(view.origin, idx, got[-1]),
                             mesh_dirty=_put(view.mesh_dirty, idx,
                                             torch.zeros(k, dtype=torch.bool, device=dev)))
        own = [j for j, s in enumerate(slots) if lo <= s < hi]
        if own:
            jt = torch.tensor(own, device=dev)
            li = idx[jt] - lo
            sub = gather_objects(sub, jt)._replace(origin=origin[jt])
            new_mesh, new_probes = remesh_and_probe(sub, idx[jt])
            meshes = CompactMesh(*(_put(old, li, new) for old, new in zip(meshes, new_mesh)))
            probes = VoxelProbes(*(_put(old, li, new) for old, new in zip(probes, new_probes)))
        return phys, view, meshes, probes

    def step(sim: SimState) -> SimState:
        phys, view = sim.phys, gathered(sim.voxels)
        prev_pos, prev_ori = phys.bodies.position, phys.bodies.orientation
        if rules:
            phys, view = apply_distance_rules(phys, view, params.dist_rules,
                                              params.casts_shadows_base)
        extra = None
        if enable_voxel_contacts:
            probes_all = VoxelProbes(*comm.all_gather_rows(list(sim.probes)))
            collidables = params.phys_params.collidables
            grid_slab_arg = None
            if split_x:  # the cells' x+1 corners: the right halo plane, once a step
                right = exchange_halo_x(view.sdf, mesh, fill=0, left=0, right=1)[1]
                grid_slab_arg = (x0, right, lambda t: row_combine(mesh, t))

            def extra(bodies, contacts):
                vc = voxel_contacts(view, probes_all, collidables, bodies.position,
                                    bodies.orientation, max_contacts, shard=(lo, hi),
                                    slab=grid_slab_arg)
                return merge_contact_buffers(contacts, merged_contacts(vc), max_contacts)

        phys = physics_step(phys, params.phys_params, dt, n_substeps, solver_cfg, max_contacts,
                            tc.solver_mode, extra)
        if dev.type == "cuda":
            phys = broadcast_tree(comm, phys, 0)
            if split_x:
                phys = broadcast_tree(comm, phys, 0, "space")
        if absorb:
            view = absorption(phys, view)
        if enable_fracturing:
            phys, view = maybe_fracture(phys, view, sim.rng)
        if enable_splitting:
            phys, view = maybe_split(phys, view)
        phys, view, meshes, probes = sync_dirty(phys, view, sim.meshes, sim.probes)
        return SimState(phys=phys, voxels=local(view), meshes=meshes, probes=probes,
                        render=sim.render, prev_position=prev_pos, prev_orientation=prev_ori,
                        rng=sim.rng)

    step.host_syncs = 0
    step.event_bytes = 0
    return step
