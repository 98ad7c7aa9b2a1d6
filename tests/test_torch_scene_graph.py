"""The port's scene graph and controllers (``scene/scene_graph.py``,
``scene/graph.py``, ``scene/controller.py``) against impact_tpu on the CPU.

Each case of ``tests/test_scene_graph.py`` (all six) and of the
``TestController`` and ``TestSceneGraph`` classes of
``tests/test_runtime_features.py:130-190`` runs on both packages; the
reference's assertions hold for the port, and every array the case returns
is held to impact_tpu's within 1e-6. The ECS graph also runs on random
Parent forests three levels deep from a numpy seed, with
``flatten_to_world_frames`` writing the frames back, and the
EntityController on a port state (its writes on the state's device).
"""

import numpy as np
import pytest
import torch

import impact_tpu.ecs as jecs
import impact_tpu.scene.controller as jcontroller
import impact_tpu.scene.graph as jgraph
import impact_tpu.scene.scene_graph as jscene_graph
import impact_tpu_torch.ecs as tecs
import impact_tpu_torch.scene.controller as tcontroller
import impact_tpu_torch.scene.graph as tgraph
import impact_tpu_torch.scene.scene_graph as tscene_graph
from impact_tpu_torch.math import quaternion as tquat

PACKAGES = {"reference": (jscene_graph, jgraph, jcontroller, jecs),
            "port": (tscene_graph, tgraph, tcontroller, tecs)}


def _quat_z(angle):
    return np.array([0.0, 0.0, np.sin(angle / 2), np.cos(angle / 2)], np.float32)


# --- tests/test_scene_graph.py, as functions of the package ---------------------------


def node_creation_and_counts(sgm):
    sg = sgm.SceneGraph()
    g = sg.create_group_node(sg.root_node_id, position=(1, 0, 0))
    i = sg.create_model_instance_node(g, model_id=7)
    c = sg.create_camera_node(g)
    assert sg.n_nodes() == 4  # root + group + instance + camera
    assert sg.has_group(g) and sg.has_instance(i)
    sg.remove_camera_node(c)
    sg.remove_model_instance_node(i)
    sg.remove_group_node(g)
    assert sg.n_nodes() == 1
    return [np.float32(sg.n_nodes())]


def group_removal_is_recursive(sgm):
    sg = sgm.SceneGraph()
    g = sg.create_group_node(sg.root_node_id)
    sg.create_model_instance_node(g, model_id=0)
    child = sg.create_group_node(g)
    sg.create_camera_node(child)
    sg.remove_group_node(g)
    assert sg.n_nodes() == 1
    with pytest.raises(ValueError):
        sg.remove_group_node(sg.root_node_id)
    return [np.float32(sg.n_nodes())]


def root_transform_propagation(sgm):
    sg = sgm.SceneGraph()
    g1 = sg.create_group_node(sg.root_node_id, position=(2, 0, 0), orientation=_quat_z(np.pi / 2))
    g2 = sg.create_group_node(g1, position=(1, 0, 0))
    sg.update_all_group_to_root_transforms()
    p, q = sg.group_to_root_transform(g2)
    np.testing.assert_allclose(p, [2.0, 1.0, 0.0], atol=1e-6)
    return [p, q]


def instance_flatten_scale_flags_and_bounds(sgm):
    sg = sgm.SceneGraph()
    g = sg.create_group_node(sg.root_node_id, position=(0, 5, 0))
    sg.create_model_instance_node(g, model_id=3, position=(1, 0, 0), scale=2.0,
                                  bounding_radius=1.5)
    hid = sg.create_model_instance_node(g, model_id=4, flags=sgm.INSTANCE_IS_HIDDEN)
    sg.create_model_instance_node(g, model_id=5, flags=sgm.INSTANCE_CASTS_NO_SHADOWS)
    sg.update_all_group_to_root_transforms()
    ids, pos, ori, scl, flg, (bc, br) = sg.instance_transforms_to_root()
    assert ids.tolist() == [3, 5]  # hidden excluded
    np.testing.assert_allclose(pos[0], [1.0, 5.0, 0.0], atol=1e-6)
    assert scl[0] == 2.0
    np.testing.assert_allclose(br[0], 3.0, atol=1e-6)
    assert flg[1] & sgm.INSTANCE_CASTS_NO_SHADOWS
    ids_all, *_ = sg.instance_transforms_to_root(include_hidden=True)
    assert sorted(ids_all.tolist()) == [3, 4, 5]
    assert sg.instance_flags(hid) & sgm.INSTANCE_IS_HIDDEN
    return [ids, pos, ori, scl, flg, bc, br, ids_all]


def camera_sync(sgm):
    sg = sgm.SceneGraph()
    g = sg.create_group_node(sg.root_node_id, position=(0, 0, 3), orientation=_quat_z(np.pi))
    cid = sg.create_camera_node(g, position=(1, 0, 0))
    sg.update_all_group_to_root_transforms()
    p, q = sg.sync_camera_view_transform(cid)
    np.testing.assert_allclose(p, [-1.0, 0.0, 3.0], atol=1e-6)
    return [p, q]


def transform_setters_take_effect(sgm):
    sg = sgm.SceneGraph()
    g = sg.create_group_node(sg.root_node_id)
    sg.update_all_group_to_root_transforms()
    p0, _ = sg.group_to_root_transform(g)
    np.testing.assert_allclose(p0, [0, 0, 0])
    sg.set_group_to_parent_transform(g, (0, 0, 9), (0, 0, 0, 1))
    sg.update_all_group_to_root_transforms()
    p1, q1 = sg.group_to_root_transform(g)
    np.testing.assert_allclose(p1, [0, 0, 9])
    return [p0, p1, q1]


SCENE_GRAPH_CASES = [node_creation_and_counts, group_removal_is_recursive,
                     root_transform_propagation, instance_flatten_scale_flags_and_bounds,
                     camera_sync, transform_setters_take_effect]


def assert_outputs_close(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape
        np.testing.assert_allclose(g.astype(np.float64), r.astype(np.float64), rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", SCENE_GRAPH_CASES, ids=lambda f: f.__name__)
def test_scene_graph_case_matches_reference(case):
    assert_outputs_close(case(tscene_graph), case(jscene_graph))


# --- tests/test_runtime_features.py TestController, TestSceneGraph ---------------


def motion_controller_directions(ctl, rotate):
    mc = ctl.MotionController(movement_speed=2.0)
    mc.set_direction("forward", True)
    v0 = mc.local_velocity()
    np.testing.assert_allclose(v0, [0, 0, -2.0], atol=1e-6)
    mc.set_direction("right", True)
    v1 = mc.local_velocity()
    assert np.linalg.norm(v1) == pytest.approx(2.0)
    w = mc.world_velocity(_quat_z(0.7))
    mc.stop()
    np.testing.assert_allclose(mc.local_velocity(), 0.0)
    return [v0, v1, w]


def orientation_roll_free(ctl, rotate):
    oc = ctl.RollFreeCameraOrientationController(sensitivity=1.0)
    oc.update(0.5, 0.2)
    q = oc.orientation()
    right = rotate(q, np.array([1.0, 0, 0], np.float32))
    assert abs(right[1]) < 1e-6  # no roll: the rotated x axis stays horizontal
    return [q, right]


def pitch_clamped(ctl, rotate):
    oc = ctl.RollFreeCameraOrientationController()
    oc.update(0.0, -100.0)
    assert oc.pitch <= 0.49 * np.pi + 1e-6
    return [np.float32(oc.pitch), oc.orientation()]


def _jax_rotate(q, v):
    from impact_tpu.math import quaternion as jquat

    return np.asarray(jquat.rotate(q, v))


def _port_rotate(q, v):
    return tquat.rotate(torch.as_tensor(q), torch.as_tensor(v)).numpy()


@pytest.mark.parametrize("case", [motion_controller_directions, orientation_roll_free,
                                  pitch_clamped], ids=lambda f: f.__name__)
def test_controller_case_matches_reference(case):
    assert_outputs_close(case(tcontroller, _port_rotate), case(jcontroller, _jax_rotate))


def test_unknown_direction_raises():
    with pytest.raises(ValueError, match="unknown direction"):
        tcontroller.MotionController().set_direction("sideways", True)


def test_entity_controller_writes_body():
    """The controlled body takes the controllers' orientation and world
    velocity, on the state's device; the other bodies and the input state
    are untouched."""
    from impact_tpu_torch.models import ball_pit
    from impact_tpu_torch.runtime import compile_scene
    from impact_tpu_torch.utils.config import EngineConfig

    cfg = EngineConfig()
    t = cfg.tpu
    t.max_voxel_objects, t.max_bodies, t.max_contacts, t.voxel_grid_size = 2, 24, 16, 16
    sim = compile_scene(ball_pit(n_balls=3), cfg, device="cpu").sim
    ctl = tcontroller.EntityController(body_index=1)
    ctl.motion.set_direction("forward", True)
    ctl.orientation.update(0.3, -0.1)
    out = ctl.apply(sim)
    b, b0 = out.phys.bodies, sim.phys.bodies
    jctl = jcontroller.EntityController(body_index=1)
    jctl.motion.set_direction("forward", True)
    jctl.orientation.update(0.3, -0.1)
    q_ref = np.asarray(jctl.orientation.orientation())
    np.testing.assert_allclose(b.orientation[1].numpy(), q_ref, atol=1e-6)
    np.testing.assert_allclose(b.velocity[1].numpy(), jctl.motion.world_velocity(q_ref),
                               atol=1e-6)
    assert np.linalg.norm(b.velocity[1].numpy()) == pytest.approx(8.0)
    keep = torch.arange(b.n) != 1
    assert torch.equal(b.velocity[keep], b0.velocity[keep])
    assert torch.equal(b.orientation[keep], b0.orientation[keep])
    assert not torch.equal(b0.velocity[1], b.velocity[1])  # the input state is not written
    # the writes follow the state's device (no values on a meta state)
    meta = sim._replace(phys=sim.phys._replace(bodies=b0._replace(
        orientation=b0.orientation.to("meta"), velocity=b0.velocity.to("meta"))))
    out_meta = ctl.apply(meta).phys.bodies
    assert out_meta.orientation.device.type == out_meta.velocity.device.type == "meta"


def parent_compose(pkg):
    _, graph, _, ecs = pkg
    C = ecs.components
    w = ecs.World(capacity=8)
    parent = w.create_entity(C.ReferenceFrame(
        position=(1.0, 0.0, 0.0),
        orientation=tuple(np.array([0, 0, np.sin(np.pi / 4), np.cos(np.pi / 4)], np.float32))))
    child = w.create_entity(C.ReferenceFrame(position=(1.0, 0.0, 0.0)),
                            C.Parent(entity_id=parent))
    p, q = graph.world_transforms(w)[child]
    np.testing.assert_allclose(p, [1.0, 1.0, 0.0], atol=1e-5)
    return [p, q]


def cycle_detection(pkg):
    _, graph, _, ecs = pkg
    C = ecs.components
    w = ecs.World(capacity=4)
    a = w.create_entity(C.ReferenceFrame())
    b = w.create_entity(C.ReferenceFrame(), C.Parent(entity_id=a))
    w.add_component(a, C.Parent(entity_id=b))
    with pytest.raises(ValueError):
        graph.world_transforms(w)
    return []


def parent_forest(pkg, seed=0, n=24):
    """Random Parent forests three levels deep (roots, children,
    grandchildren), some entities without a ReferenceFrame; the composed
    transforms, then the frames flatten_to_world_frames writes back."""
    _, graph, _, ecs = pkg
    C = ecs.components
    rng = np.random.default_rng(seed)
    w = ecs.World(capacity=64)
    ids = []
    for i in range(n):
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        comps = []
        if i % 7 != 3:
            comps.append(C.ReferenceFrame(position=tuple(rng.uniform(-3, 3, 3)),
                                          orientation=tuple(q)))
        if i >= 4:  # parents from the level above: 0-3 roots, 4-11 children, 12- grandchildren
            lo, hi = (0, 4) if i < 12 else (4, 12)
            comps.append(C.Parent(entity_id=ids[int(rng.integers(lo, hi))]))
        ids.append(w.create_entity(*comps))
    t = graph.world_transforms(w)
    out = [np.concatenate([t[e][0], t[e][1]]) for e in ids]
    graph.flatten_to_world_frames(w)
    for e in ids:
        if w.has_component(e, C.ReferenceFrame):
            rf = w.get_component(e, C.ReferenceFrame)
            out.append(np.concatenate([np.asarray(rf.position), np.asarray(rf.orientation)]))
    return out


@pytest.mark.parametrize("case", [parent_compose, cycle_detection, parent_forest],
                         ids=lambda f: f.__name__)
def test_ecs_graph_case_matches_reference(case):
    assert_outputs_close(case(PACKAGES["port"]), case(PACKAGES["reference"]))
