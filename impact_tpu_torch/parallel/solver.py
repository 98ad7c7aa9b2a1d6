"""The contact solve with the bodies split over the ``objects`` axis and the
contacts replicated (the sharded solve of ``tests/test_parallel.py:205-242``,
which places every [N] body leaf ``P("objects")`` and the prepared contacts
``P()``, and lets GSPMD partition ``solve_contacts``).

Each rank holds its block of N/n_objects body rows (``mesh.shard_bodies``;
replicated over ``space``) and the whole ``PreparedContacts``. A solve
returns the rank's block of the solved bodies and the whole ``SolverCache``;
gathered (``mesh.gather_bodies``), the bodies are the single-process
``physics.solver.solve_contacts``'s.

* ``jacobi``: the rank computes its rows' velocities and world inverse
  inertias and warm-starts them. Each velocity iteration gathers the
  velocity rows ([N/n, 6] a rank) in one collective; every rank then
  computes the per-contact impulses and clamps (the contacts are whole)
  and accumulates into its own rows only: the segment path reads its rows'
  boundaries of one prefix sum over all 2C sided entries, the one-hot path
  (below ``SEGMENT_ACCUMULATION_MIN_BODIES``) slices its rows of the whole
  product. The correction gathers the inverse masses and inertias once and
  the positions and orientations ([N/n, 7]) each iteration; the cache reads
  the written-back positions, gathered once at the end. Nothing of shape
  [C, N] or [C, N/n] is built on the segment path, and no collective
  carries contacts.
* ``scan``: Gauss-Seidel couples every slot to the slots before it through
  shared bodies, so the chain crosses every split of the bodies and no
  rank owns a part of it. The rank warm-starts its rows, the rows are
  gathered once, and every rank runs ``scan_iterations`` on the whole
  bodies (the kernels of ``csrc/scan_solver.cu`` on the card, the plain
  loop on the CPU), as the reference's partitioned program gives it; each
  keeps its rows.

Every collective goes through the mesh's ``Comm`` (recorded in
``comm.records``). The tensors live on the mesh's device.
"""

from __future__ import annotations

import torch

from ..physics.scan_solver import scan_iterations
from ..physics.solver import (
    JACOBI_RELAXATION,
    check_mode,
    jacobi_sweeps,
    participants,
    solver_cache,
    warm_start,
    write_back,
)
from ..physics.state import compute_velocities, world_inv_inertia
from .mesh import DeviceMesh


def _on(tree, device):
    return type(tree)(*(t.to(device) for t in tree))


def sharded_solve_contacts(mesh: DeviceMesh, bodies, prep, config, mode: str = "scan",
                           jacobi_relaxation: float = JACOBI_RELAXATION):
    """``solve_contacts`` on the rank's block of bodies (``shard_bodies``)
    and the whole prepared contacts → (the rank's block of the solved
    bodies, the whole SolverCache). Every rank of the mesh calls it."""
    check_mode(mode)
    comm = mesh.comm
    bodies, prep = _on(bodies, mesh.device), _on(prep, mesh.device)
    n_loc = bodies.n
    lo = comm.coordinate("objects") * n_loc
    n = n_loc * comm.size("objects")
    rows = (lo, lo + n_loc)

    def gather(tensors):
        return comm.all_gather_rows(tensors, "objects")

    v, w = compute_velocities(bodies)
    inv_inertia = world_inv_inertia(bodies)
    inv_mass = bodies.inv_mass
    acc, v, w = warm_start(prep, v, w, inv_mass, inv_inertia, rows)
    pm = participants(n, prep.body_a, prep.body_b, prep.active)
    if mode == "scan":
        v, w, pos, ori, inv_mass, inv_inertia = gather(
            [v, w, bodies.position, bodies.orientation, inv_mass, inv_inertia])
        v, w, acc, pos_new, ori_new = scan_iterations(
            v, w, pos, ori, inv_mass, inv_inertia, prep, acc, config.n_iterations,
            config.n_positional_correction_iterations, config.positional_correction_factor)
        local = write_back(bodies, pm[lo:lo + n_loc], *(t[lo:lo + n_loc] for t in (
            v, w, pos_new, ori_new)))
        return local, solver_cache(prep, acc, torch.where(pm, pos_new, pos))
    v, w, acc, pos, ori = jacobi_sweeps(prep, config, jacobi_relaxation, n, v, w, acc,
                                        bodies.position, bodies.orientation, inv_mass,
                                        inv_inertia, rows, gather)
    local = write_back(bodies, pm[lo:lo + n_loc], v, w, pos, ori)
    (position,) = gather([local.position])
    return local, solver_cache(prep, acc, position)
