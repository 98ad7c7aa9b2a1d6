"""``make_engine_step(..., remesh_budget=k)`` against impact_tpu on the CPU,
over the steps of a fracture: the fracturing scene of
``tests/test_torch_engine_step.py`` (12 fragment slots, the uniforms JAX
draws from its key handed to the port) stepped through its event and four
steps after it by both packages' steps built with ``remesh_budget=1``, so
that the fragments sync and re-mesh one a step, lowest slots first. The
bars are that test's: event step, alive and pending masks, per-slot voxel
counts and i8 SDFs equal, body positions within 1e-3. The default budget
(``None``) is that test's own run; here its plan is checked to be the
reference's default, as the explicit value gives it."""

import jax
import numpy as np
import torch
from test_torch_chunked_engine import few_torch_threads  # noqa: F401  (an autouse fixture)
from test_torch_engine_step import N_FRAG, _configure, _jax_fracture_build, jax_event_uniforms

from impact_tpu.runtime.engine import make_engine_step as jmake_step
from impact_tpu_torch.models.bench import bench_fracture_scene
from impact_tpu_torch.runtime import compile_scene as tcompile
from impact_tpu_torch.runtime.engine import make_engine_step, step_plan
from impact_tpu_torch.utils.config import EngineConfig as TConfig


def test_fracture_steps_at_remesh_budget_one_match_the_reference():
    jc, jbuild = _jax_fracture_build()
    tc = _configure(TConfig(), N_FRAG + 4, N_FRAG + 8)
    tc.tpu.max_contacts = 1024
    tc.tpu.max_fracture_fragments, tc.tpu.max_fracture_events = N_FRAG, 1
    tbuild = tcompile(bench_fracture_scene(), tc, device="cpu")
    uniforms = jax_event_uniforms(jbuild.sim.rng, N_FRAG)
    caps = (tbuild.info["mesh_vert_cap"], tbuild.info["mesh_tri_cap"])
    assert caps == (jbuild.info["mesh_vert_cap"], jbuild.info["mesh_tri_cap"])
    jstep = jax.jit(jmake_step(jbuild.params, jc, *caps, remesh_budget=1))
    tstep = make_engine_step(tbuild.params, tc, *caps, remesh_budget=1,
                             fracture_uniforms=lambda gen, n: uniforms)
    default = step_plan(tbuild.params, tc, True, True).remesh_budget
    assert default == min(N_FRAG + 4, max(4, N_FRAG)) == step_plan(
        tbuild.params, tc, True, True, remesh_budget=default).remesh_budget
    assert step_plan(tbuild.params, tc, True, True, remesh_budget=1).remesh_budget == 1
    jsim, tsim = jbuild.sim, tbuild.sim
    alive0 = int(np.asarray(jsim.voxels.alive).sum())
    event, dirty_left = None, 0
    for i in range(1, 201):
        jsim, tsim = jstep(jsim, jbuild.params), tstep(tsim)
        j_alive = int(np.asarray(jsim.voxels.alive).sum())
        assert int(tsim.voxels.alive.sum()) == j_alive, i
        np.testing.assert_array_equal(tsim.voxels.mesh_dirty.numpy(),
                                      np.asarray(jsim.voxels.mesh_dirty), err_msg=str(i))
        if j_alive > alive0 and event is None:
            event = i
        if event is not None:
            dirty_left = max(dirty_left, int(tsim.voxels.mesh_dirty.sum()))
        if event is not None and i >= event + 4:
            break
    assert event is not None and j_alive - alive0 >= 2
    assert dirty_left >= 1  # a budget of one leaves fragments dirty after the event
    jv, tv = jsim.voxels, tsim.voxels
    np.testing.assert_array_equal(tv.alive.numpy(), np.asarray(jv.alive))
    np.testing.assert_array_equal(tv.split_pending.numpy(), np.asarray(jv.split_pending))
    np.testing.assert_array_equal((tv.sdf < 0).sum(dim=(1, 2, 3)).numpy(),
                                  (np.asarray(jv.sdf) < 0).sum(axis=(1, 2, 3)))
    np.testing.assert_array_equal(tv.sdf.numpy(), np.asarray(jv.sdf))
    np.testing.assert_allclose(tsim.phys.bodies.position.numpy(),
                               np.asarray(jsim.phys.bodies.position), atol=1e-3)
    assert torch.isfinite(tsim.phys.bodies.position).all()
