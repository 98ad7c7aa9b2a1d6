"""The port's ECS world against impact_tpu's on the CPU.

* The cases of ``tests/test_ecs.py`` run on both packages' worlds with the
  same inputs; each must pass in both, and the two worlds must end equal.
* The two component registries are equal: names, ids, fields, dtypes,
  shapes, defaults and categories of all 66 components.
* ``bridge.world_from_reference`` carries a reference world across, entity
  ids, order and every column included.
* Every builder of ``models/scenes.py`` and ``models/bench.py``, and the
  game's range world, gives a world equal to the bridged reference world
  that the reference's builder (with ``bench.py``'s edits) makes.
* The FNV-1a vectors of ``tests/test_utils.py:70-80``.

Equal here is exact: ids, masks and every column, floats included.
"""

import numpy as np
import pytest

import impact_tpu.ecs as jecs
import impact_tpu.ecs.components as JC
import impact_tpu.models.scenes as jscenes
import impact_tpu_torch.ecs as tecs
import impact_tpu_torch.ecs.components as TC
from impact_tpu.utils import hashing as jhashing
from impact_tpu_torch import bridge
from impact_tpu_torch.apps import impact_game
from impact_tpu_torch.models import bench as tbench
from impact_tpu_torch.models import scenes as tscenes
from impact_tpu_torch.utils import hashing


@jecs.component
class _TorchPortTestTag:
    value: int = 7


@tecs.component
class _TorchPortTestTag:  # noqa: F811  (the same tag, in the port's registry)
    value: int = 7


PACKAGES = {"reference": (jecs, JC, jecs.component_registry()["_TorchPortTestTag"].cls),
            "port": (tecs, TC, tecs.component_registry()["_TorchPortTestTag"].cls)}


def assert_worlds_equal(got, ref):
    """Entity ids, liveness, component masks and columns all equal."""
    np.testing.assert_array_equal(got.alive, ref.alive)
    np.testing.assert_array_equal(got.entity_ids, ref.entity_ids)
    assert got._next_counter_id == ref._next_counter_id
    names = {n for n, c in ref._columns.items() if c["__mask__"].any()}
    assert names == {n for n, c in got._columns.items() if c["__mask__"].any()}
    for name in names:
        g, r = got._columns[name], ref._columns[name]
        assert set(g) == set(r), name
        for f in r:
            assert g[f].dtype == r[f].dtype, (name, f)
            np.testing.assert_array_equal(g[f], r[f], err_msg=f"{name}.{f}")


# --- the cases of tests/test_ecs.py, on each package ------------------------------


def case_create_and_query(ecs, C, tag):
    w = ecs.World(capacity=16)
    e1 = w.create_entity(C.ReferenceFrame(position=(1.0, 2.0, 3.0)),
                         C.Motion(linear_velocity=(1.0, 0.0, 0.0)))
    e2 = w.create_entity(C.ReferenceFrame(position=(4.0, 5.0, 6.0)))
    assert w.n_alive == 2
    idx, _ = w.query(C.ReferenceFrame, C.Motion)
    assert len(idx) == 1 and idx[0] == w.entity_index(e1)
    assert len(w.query(C.ReferenceFrame)[0]) == 2
    idx3, _ = w.query(C.ReferenceFrame, excluded=[C.Motion])
    assert len(idx3) == 1 and idx3[0] == w.entity_index(e2)
    assert w.entities_with(C.Motion) == [e1]
    return w


def case_column_mutation_visible(ecs, C, tag):
    w = ecs.World(capacity=8)
    e = w.create_entity(C.ReferenceFrame(position=(0.0, 0.0, 0.0)))
    idx, [rf] = w.query(C.ReferenceFrame)
    rf["position"][idx] += np.array([1.0, 1.0, 1.0])
    np.testing.assert_allclose(w.get_component(e, C.ReferenceFrame).position, [1.0, 1.0, 1.0])
    w.set_field(e, C.ReferenceFrame, "orientation", (0.0, 1.0, 0.0, 0.0))
    np.testing.assert_array_equal(w.column(C.ReferenceFrame, "orientation")[idx[0]],
                                  [0.0, 1.0, 0.0, 0.0])
    return w


def case_remove_entity_frees_slot(ecs, C, tag):
    w = ecs.World(capacity=4)
    ids = [w.create_entity(C.ReferenceFrame()) for _ in range(4)]
    w.remove_entity(ids[1])
    assert w.n_alive == 3
    e_new = w.create_entity(C.Motion())
    assert w.n_alive == 4 and not w.has_component(e_new, C.ReferenceFrame)
    return w


def case_capacity_exhaustion_raises(ecs, C, tag):
    w = ecs.World(capacity=2)
    w.create_entity()
    w.create_entity()
    with pytest.raises(RuntimeError):
        w.create_entity()
    return w


def case_entity_ids_stable_and_custom(ecs, C, tag):
    w = ecs.World(capacity=8)
    assert w.create_entity(entity_id=12345) == 12345
    with pytest.raises(ValueError):
        w.create_entity(entity_id=12345)
    return w


def case_component_fields_roundtrip(ecs, C, tag):
    w = ecs.World(capacity=8)
    e = w.create_entity(C.SphericalCollidable(kind=0, center=(0.0, 1.0, 0.0), radius=2.5,
                                              restitution=0.9))
    c = w.get_component(e, C.SphericalCollidable)
    assert c.radius == pytest.approx(2.5) and c.restitution == pytest.approx(0.9)
    np.testing.assert_allclose(c.center, [0.0, 1.0, 0.0])
    w.remove_component(e, C.SphericalCollidable)
    assert not w.has_component(e, C.SphericalCollidable)
    return w


def case_setup_components_strip(ecs, C, tag):
    w = ecs.World(capacity=8)
    e = w.create_entity(C.ReferenceFrame(), C.DynamicRigidBodySubstance(mass_density=2.0),
                        C.ConstantAcceleration())
    assert w.has_component(e, C.DynamicRigidBodySubstance)
    w.strip_setup_components(e)
    assert not w.has_component(e, C.DynamicRigidBodySubstance)
    assert not w.has_component(e, C.ConstantAcceleration)
    assert w.has_component(e, C.ReferenceFrame)
    return w


def case_staged_create_remove(ecs, C, tag):
    w = ecs.World(capacity=8)
    e1 = w.create_entity(C.ReferenceFrame())
    w.stager.stage_creation(C.ReferenceFrame(position=(1.0, 0.0, 0.0)), tag(value=3))
    w.stager.stage_removal(e1)
    assert w.n_alive == 1 and w.stager.pending
    created = w.stager.apply()
    assert len(created) == 1 and w.n_alive == 1
    assert w.get_component(created[0], tag).value == 3
    assert not w.has_entity(e1)
    return w


CASES = [case_create_and_query, case_column_mutation_visible, case_remove_entity_frees_slot,
         case_capacity_exhaustion_raises, case_entity_ids_stable_and_custom,
         case_component_fields_roundtrip, case_setup_components_strip,
         case_staged_create_remove]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__.removeprefix("case_"))
def test_ecs_case_in_both_packages(case):
    ref = case(*PACKAGES["reference"])
    got = case(*PACKAGES["port"])
    assert_worlds_equal(got, ref)


def test_component_registries_are_equal():
    """All 66 components of ``ecs/components.py``: the same names, FNV-1a
    u64 ids, fields (name, per-entity shape, dtype), defaults and
    categories in both packages."""
    def of(module):
        return {name: cls.__component_meta__ for name, cls in vars(module).items()
                if hasattr(cls, "__component_meta__")}

    ref, port = of(JC), of(TC)
    assert len(ref) == 66 and list(port) == list(ref)
    for name, r in ref.items():
        p = port[name]
        assert p.name == r.name and p.category == r.category, name
        assert p.component_id == r.component_id == hashing.hash_str_to_u64(name), name
        assert [(f.name, f.shape, np.dtype(f.dtype)) for f in p.fields] == [
            (f.name, f.shape, np.dtype(f.dtype)) for f in r.fields], name
        for f in r.fields:
            np.testing.assert_array_equal(np.asarray(getattr(p.cls(), f.name), f.dtype),
                                          np.asarray(getattr(r.cls(), f.name), f.dtype))


def test_world_from_reference_round_trips():
    """A reference world with a removed entity (a hole in its slots), u64
    references, setup and standard components: the bridged world holds the
    same ids in the same order, the same columns, and goes on numbering new
    entities where the reference would."""
    w = jecs.World(capacity=16)
    a = w.create_entity(JC.ReferenceFrame(position=(1.0, 2.0, 3.0)), JC.KinematicRigidBodyMarker())
    gone = w.create_entity(JC.Motion(linear_velocity=(1.0, 0.0, 0.0)))
    b = w.create_entity(JC.ReferenceFrame(orientation=(0.0, 0.6, 0.0, 0.8)),
                        JC.DynamicRigidBodyInertialProperties(mass=3.0),
                        JC.SphericalCollidable(radius=0.25), JC.SceneEntityFlags(flags=2))
    w.create_entity(JC.SphericalJoint(entity_a=a, entity_b=b, anchor_b=(0.5, 0.0, 0.0)),
                    entity_id=77)
    w.create_entity(JC.GradientNoiseVoxelTypes(n_voxel_types=3, voxel_types=(2, 1, 0, 0),
                                               seed=0xFFFFFFF0))
    w.remove_entity(gone)
    port = bridge.world_from_reference(w)
    assert port.entities_with() == w.entities_with()
    assert_worlds_equal(port, w)
    joint = port.get_component(77, TC.SphericalJoint)
    assert (joint.entity_a, joint.entity_b) == (a, b)
    assert port.create_entity() == w.create_entity()


def _bench_step_reference():
    world = _bench_reference()
    for i, eid in enumerate(world.entities_with(JC.VoxelBox)):
        pos = world.get_component(eid, JC.ReferenceFrame).position
        pos[1] = 6.0 + tbench.STEP_SPACING * i
        world.set_field(eid, JC.ReferenceFrame, "position", pos)
    return world


def _bench_reference():
    """bench.py:182-191."""
    world = jscenes.voxel_box_tumbler(n_boxes=tbench.N_BOXES, seed=tbench.SEED)
    for eid in world.entities_with(JC.VoxelBox):
        for f in ("extent_x", "extent_y", "extent_z"):
            world.set_field(eid, JC.VoxelBox, f, 26.0)
    return world


def _fracture_reference():
    """bench.py:483-491."""
    world = jscenes.fracturing()
    for eid in world.entities_with(JC.FracturingProperties):
        world.set_field(eid, JC.FracturingProperties, "fracture_radius", 2.5)
        world.set_field(eid, JC.FracturingProperties, "impulse_threshold", 5.0)
    return world


def _chunked_reference(radius):
    """bench.py:592-604."""
    world = jscenes.asteroid()
    for eid in world.entities_with(JC.VoxelSphere):
        world.set_field(eid, JC.VoxelSphere, "radius", radius)
    world.create_entity(JC.ReferenceFrame(position=(4.0, 4.0, 0.0)),
                        JC.VoxelAbsorbingSphere(offset=(0.0, 0.0, 0.0), radius=3.0, rate=2.0))
    return world


def _range_reference():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "apps" / "impact_game.py"
    spec = importlib.util.spec_from_file_location("reference_impact_game", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build_range_world()


BUILDERS = {
    **{name: (lambda n=name: tscenes.SCENES[n](), lambda n=name: jscenes.SCENES[n]())
       for name in tscenes.SCENES},
    "RenderingTest_bloom": (lambda: tscenes.rendering_test(omni="plain", uni=None,
                                                           emissive_sphere=True),
                            lambda: jscenes.rendering_test(omni="plain", uni=None,
                                                           emissive_sphere=True)),
    "bench_scene": (tbench.bench_scene, _bench_reference),
    "bench_step_scene": (tbench.bench_step_scene, _bench_step_reference),
    "bench_fracture_scene": (tbench.bench_fracture_scene, _fracture_reference),
    "bench_chunked_scene_64": (lambda: tbench.bench_chunked_scene(64),
                               lambda: _chunked_reference((64 / 2 - 4) * 0.3)),
    "bench_chunked_fill_scene_128": (lambda: tbench.bench_chunked_fill_scene(128),
                                     lambda: _chunked_reference(128 / 2 - 4)),
    "range_world": (impact_game.build_range_world, _range_reference),
}


@pytest.mark.parametrize("name", list(BUILDERS))
def test_builder_world_equals_the_reference(name):
    port_builder, ref_builder = BUILDERS[name]
    assert_worlds_equal(port_builder(), bridge.world_from_reference(ref_builder()))


@pytest.mark.parametrize("h", ["u32", "u64"])
def test_fnv1a_vectors(h):
    """tests/test_utils.py:70-80's vectors, and the reference's values."""
    want = {"u32": {"": 0x811C9DC5, "a": 0xE40C292C},
            "u64": {"": 0xCBF29CE484222325, "a": 0xAF63DC4C8601EC8C}}[h]
    fn = getattr(hashing, f"hash_str_to_{h}")
    for s, v in want.items():
        assert fn(s) == v
    assert fn("foo") != fn("bar")
    for s in ("", "a", "VoxelBox", "textured-box-checker", "ü"):
        assert fn(s) == getattr(jhashing, f"hash_str_to_{h}")(s)
