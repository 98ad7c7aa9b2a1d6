"""The port must run where JAX is not installed: every module of
impact_tpu_torch, and chip_smoke.py, import with ``jax`` blocked, and no
source file of the port imports the reference package."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "impact_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_port_modules_import_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['impact_tpu'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v is not None}\n"
        "print('ok', len(" + repr(MODULES) + "))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_reference_or_jax_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "impact_tpu"), f"{path}: imports {name}"


ENTRY_MODULES = ("impact_tpu_torch.runtime.setup", "impact_tpu_torch.bridge",
                 "impact_tpu_torch.apps.snapshot_tester", "impact_tpu_torch.render.textures",
                 "impact_tpu_torch.render.pipeline", "impact_tpu_torch.apps.impact_game",
                 "impact_tpu_torch.runtime.checkpoint", "impact_tpu_torch.apps.voxel_generator",
                 "impact_tpu_torch.scene.mesh", "impact_tpu_torch.apps.parity_snapshots",
                 "impact_tpu_torch.parallel.dryrun", "impact_tpu_torch.parallel.mesh")


@pytest.mark.parametrize("module", ENTRY_MODULES)
def test_entry_points_default_to_the_card(module):
    """Every public function of the entry-point modules that takes a
    ``device`` puts its tensors on ``cuda`` unless told otherwise."""
    import importlib
    import inspect

    mod = importlib.import_module(module)
    fns = [f for n, f in inspect.getmembers(mod, inspect.isfunction)
           if f.__module__ == module and not n.startswith("_")
           and "device" in inspect.signature(f).parameters]
    assert fns, module
    for f in fns:
        assert inspect.signature(f).parameters["device"].default == "cuda", f.__name__


def test_api_entry_points_default_to_the_card():
    """compile_scene, the game's play and the checkpoint loader by name."""
    import inspect

    from impact_tpu_torch.apps.impact_game import play
    from impact_tpu_torch.runtime import compile_scene
    from impact_tpu_torch.runtime.checkpoint import load_checkpoint

    for f in (compile_scene, play, load_checkpoint):
        assert inspect.signature(f).parameters["device"].default == "cuda", f.__name__


def test_generation_entry_points_default_to_the_card():
    """compile_scene with sdf_generators, and the voxel generator's CLI,
    run on ``cuda`` unless told otherwise."""
    import inspect

    from impact_tpu_torch.apps import voxel_generator
    from impact_tpu_torch.runtime import compile_scene

    params = inspect.signature(compile_scene).parameters
    assert "sdf_generators" in params and params["device"].default == "cuda"
    seen = {}
    run = voxel_generator.cmd_stats
    voxel_generator.cmd_stats = lambda path, device: seen.update(path=path, device=device)
    try:
        assert voxel_generator.main(["stats", "graph.json"]) == 0
    finally:
        voxel_generator.cmd_stats = run
    assert seen == {"path": "graph.json", "device": "cuda"}


SLICE13_MODULES = ("impact_tpu_torch.math.morton", "impact_tpu_torch.geometry.aabb",
                   "impact_tpu_torch.geometry.bvh", "impact_tpu_torch.render.gizmos",
                   "impact_tpu_torch.scene.graph", "impact_tpu_torch.scene.scene_graph",
                   "impact_tpu_torch.scene.controller", "impact_tpu_torch.models.parity_scenes",
                   "impact_tpu_torch.apps.parity_snapshots")


def test_slice13_modules_are_checked():
    """The gizmo, scene-graph and parity modules are among those imported
    with jax blocked above."""
    assert set(SLICE13_MODULES) <= set(MODULES)


def test_parity_and_controller_entry_points_default_to_the_card(tmp_path):
    """The parity harness's build_runtime and CLI run on ``cuda`` unless
    told otherwise; EntityController.apply writes on the state's own device
    (a meta-device state stays on meta: nothing falls back to the CPU)."""
    import inspect
    from typing import NamedTuple

    import torch

    from impact_tpu_torch.apps import parity_snapshots
    from impact_tpu_torch.physics.state import BodyState
    from impact_tpu_torch.physics.step import PhysicsState
    from impact_tpu_torch.scene.controller import EntityController

    params = inspect.signature(parity_snapshots.build_runtime).parameters
    assert params["device"].default == "cuda"
    seen = {}
    run = parity_snapshots.run

    def fake_run(names, cfg, device, goldens, out_dir):
        seen.update(names=names, device=device)
        return {}, {}

    parity_snapshots.run = fake_run
    try:
        assert parity_snapshots.main(["--scene", "Bloom", "--out-dir", str(tmp_path)]) == 0
    finally:
        parity_snapshots.run = run
    assert seen == {"names": ["Bloom"], "device": "cuda"}

    class State(NamedTuple):
        phys: PhysicsState

    bodies = BodyState(*(torch.zeros((3, 4) if f == "orientation" else (3, 3), device="meta")
                         for f in BodyState._fields))
    state = State(PhysicsState(bodies=bodies, solver_cache=None, time=None))
    out = EntityController(body_index=1).apply(state).phys.bodies
    assert out.orientation.device.type == out.velocity.device.type == "meta"


def test_parallel_entry_points_default_to_the_card(monkeypatch):
    """The dry run's CLI, make_device_mesh and the rank spawner run on
    ``cuda`` unless told otherwise."""
    import inspect

    from impact_tpu_torch.parallel import dryrun, make_device_mesh
    from impact_tpu_torch.parallel.world import World

    assert "impact_tpu_torch.parallel.dryrun" in MODULES
    seen = {}
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device, backend: seen.update(n=n, device=device,
                                                               backend=backend))
    assert dryrun.main([]) == 0
    assert seen == {"n": 8, "device": "cuda", "backend": None}
    for f in (make_device_mesh, World.__init__):
        assert inspect.signature(f).parameters["device"].default == "cuda", f.__qualname__


# the modules the space axis through the sharded step changed or added
SPACE_AXIS_MODULES = (
    "impact_tpu_torch.parallel.step", "impact_tpu_torch.parallel.halo",
    "impact_tpu_torch.parallel.mesh", "impact_tpu_torch.parallel.comm",
    "impact_tpu_torch.parallel.jobs", "impact_tpu_torch.parallel.dryrun",
    "impact_tpu_torch.voxel.object", "impact_tpu_torch.voxel.inertia",
    "impact_tpu_torch.voxel.collision", "impact_tpu_torch.voxel.mesh",
    "impact_tpu_torch.voxel.interaction", "impact_tpu_torch.runtime.engine",
    "impact_tpu_torch.ops.ccl_pallas", "impact_tpu_torch._build")


def test_space_axis_modules_import_with_jax_blocked():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['impact_tpu'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        f"for m in {SPACE_AXIS_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v is not None}\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_dryrun_command_defaults_to_the_card(monkeypatch):
    """``python -m impact_tpu_torch.parallel.dryrun`` with no flags: 8 ranks
    on ``cuda``, the transport picked by the rule."""
    from impact_tpu_torch.parallel import dryrun

    seen = {}
    monkeypatch.setattr(dryrun, "dryrun_multichip",
                        lambda n, device, backend: seen.update(n=n, device=device,
                                                               backend=backend))
    assert dryrun.main([]) == 0
    assert seen == dict(n=8, device="cuda", backend=None)


def test_sharded_solve_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['impact_tpu'] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import impact_tpu_torch.parallel.solver as s\n"
        "from impact_tpu_torch.parallel import sharded_solve_contacts, shard_bodies\n"
        "assert s.sharded_solve_contacts is sharded_solve_contacts\n"
        "assert 'jax' not in {k.split('.')[0] for k, v in sys.modules.items() if v is not None}\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(ROOT), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_sharded_solve_runs_on_the_mesh_device():
    """``sharded_solve_contacts`` takes no device: its tensors go to the
    mesh's, which ``make_device_mesh`` puts on ``cuda`` unless told
    otherwise. On a one-rank mesh on the meta device, jacobi solves there
    and scan raises (the scan solver runs on cuda or cpu tensors): nothing
    falls back to the CPU."""
    import inspect
    import types

    import torch

    from impact_tpu_torch.parallel import make_device_mesh, sharded_solve_contacts
    from impact_tpu_torch.parallel.jobs import solver_scene

    assert "device" not in inspect.signature(sharded_solve_contacts).parameters
    assert inspect.signature(make_device_mesh).parameters["device"].default == "cuda"

    class OneRank:
        def size(self, axis):
            return 1

        def coordinate(self, axis):
            return 0

        def all_gather_rows(self, tensors, axis="objects"):
            return list(tensors)

    mesh = types.SimpleNamespace(device=torch.device("meta"), comm=OneRank())
    bodies, prep, cfg = solver_scene(8, 16, "cpu", 5)
    out, cache = sharded_solve_contacts(mesh, bodies, prep, cfg, "jacobi")
    assert out.velocity.device.type == cache.impulses.device.type == "meta"
    with pytest.raises(ValueError, match="not meta"):
        sharded_solve_contacts(mesh, bodies, prep, cfg, "scan")
