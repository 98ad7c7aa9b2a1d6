"""The reference's public surface, name by name: every public top-level
``def`` and ``class``, every public module-level name and every ``__all__``
entry of ``impact_tpu/`` has its namesake in the port's module of the same
path; the positional parameters of same-named functions agree in order (the
port may add trailing ones, such as ``device``); and a subpackage's
``__all__`` lists the reference's names. Both packages are parsed with
``ast``; nothing is imported. What differs by design is in
``DIFFERENCES``, one line of reason each, and ``ROADMAP.md`` Queue 3 lists
every entry."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "impact_tpu"
PORT = ROOT / "impact_tpu_torch"

DIFFERENCES = {
    "parallel/halo.py:exchange_halo_x":
        "takes a torch.distributed mesh and axis, not a shard_map axis name",
    "parallel/mesh.py:make_device_mesh":
        "builds torch.distributed groups: one device, a backend and ranks, not a device list",
    "voxel/interaction.py:sample_fracture_seeds":
        "takes the event's uniforms (from a torch.Generator), not a threefry key",
    "voxel/interaction.py:fracture_object":
        "takes the event's uniforms (from a torch.Generator), not a threefry key",
    "render/lights.py:omni_shadow_visibility":
        "reads the quad-packed cube maps [6,S,S,4], not the depth maps",
    "render/lights.py:uni_cascade_visibility":
        "reads the quad-packed cascade maps [C,S,S,4], not the depth maps",
    "voxel/collision.py:sample_sdf_trilinear_with_gradient":
        "samples a batch of grids by object index (and x0 for slabs); "
        "sample_sdf_trilinear/_gradient take one grid",
    "ops/ccl_pallas.py:ccl_propagate_sweeps":
        "no interpret flag: a CPU tensor runs the plain sweeps; the port's "
        "sweeps are 6-connected",
    "ops/ccl_pallas.py:connected_component_labels_pallas":
        "no interpret flag: a CPU tensor runs the plain labels; the port's "
        "labels are 6-connected",
}


def _modules():
    return sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _surface(path):
    """(defs and classes {name: node}, the names the module defines, the
    names it defines or imports, ``__all__`` or None) of one module."""
    tree = ast.parse(path.read_text())
    defs, names, imported, exported = {}, set(), set(), None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
            defs[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        exported = ast.literal_eval(node.value)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            imported.update((a.asname or a.name).split(".")[0] for a in node.names)
    return defs, names, names | imported, exported


def _positional(node):
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return None
    return [a.arg for a in node.args.posonlyargs + node.args.args]


def _differences(rel):
    """The names of reference module ``rel`` that the port lacks or whose
    positional parameters the port's do not begin with."""
    ref_defs, ref_names, _, ref_all = _surface(REF / rel)
    port_path = PORT / rel
    if not port_path.exists():
        return {f"{rel}:(module)"}
    port_defs, _, port_names, port_all = _surface(port_path)
    wanted = {n for n in ref_names if not n.startswith("_")} | set(ref_all or ())
    out = {f"{rel}:{n}" for n in wanted if n not in port_names}
    for name, node in ref_defs.items():
        if name.startswith("_") or name not in port_defs:
            continue
        a, b = _positional(node), _positional(port_defs[name])
        if a is not None and (b is None or b[:len(a)] != a):
            out.add(f"{rel}:{name}")
    if ref_all is not None and not set(ref_all) <= set(port_all or ()):
        out.add(f"{rel}:__all__")
    return out


@pytest.mark.parametrize("rel", _modules())
def test_module_surface_matches_the_reference(rel):
    found = _differences(rel)
    listed = {k for k in DIFFERENCES if k.startswith(f"{rel}:")}
    assert found - listed == set(), f"missing from the port: {sorted(found - listed)}"
    assert listed - found == set(), f"listed but not a difference: {sorted(listed - found)}"


def test_every_difference_has_its_reason_and_its_roadmap_line():
    roadmap = (ROOT / "ROADMAP.md").read_text()
    queue3 = roadmap[roadmap.index("### Queue 3"):]
    for key, reason in DIFFERENCES.items():
        assert reason and "\n" not in reason, key
        rel, name = key.split(":")
        assert f"`{rel}:{name}`" in queue3, key


def test_new_modules_are_imported_with_jax_blocked():
    from test_torch_no_jax import MODULES

    for m in ("impact_tpu_torch.utils.jpeg", "impact_tpu_torch.utils.image",
              "impact_tpu_torch.geometry", "impact_tpu_torch.math", "impact_tpu_torch.ops",
              "impact_tpu_torch.physics", "impact_tpu_torch.render", "impact_tpu_torch.voxel",
              "impact_tpu_torch.scene"):
        assert m in MODULES, m
