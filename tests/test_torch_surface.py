"""The reference's public surface, name by name and member by member:
every public top-level ``def`` and ``class``, every public module-level
name and every ``__all__`` entry of ``impact_tpu/`` and of the root
``apps/`` has its namesake in the port's module of the same path
(``impact_tpu_torch/apps/`` for the apps); the positional parameters of
same-named functions and methods agree in order (the port may add trailing
ones, such as ``device``), every keyword-only parameter is there and every
parameter default is equal (``jnp.X`` read as ``torch.X``, a module
constant as its literal); every public class has the reference's public
members (methods, properties, static and class methods, class attributes
and the names its methods assign to ``self``), each of the same kind; the
fields of each NamedTuple and dataclass have the reference's names, order,
defaults and default values; and a subpackage's ``__all__`` lists the
reference's names. Both packages are parsed with ``ast``; nothing is
imported. An alias to a class (``Name = Class``) counts as the class;
decorators other than ``staticmethod``, ``classmethod`` and ``property``
are not compared. What differs by design is in ``DIFFERENCES``, one line
of reason each, keyed ``module:name``, ``module:Class.member``,
``module:Class(fields)`` or ``module:function(parameter)``, and
``ROADMAP.md`` Queue 3 lists every entry. ``bench.py`` and the TPU probe
harnesses of ``devtools/`` are not walked: the probes' counterparts are the
Hopper kernels' own entries."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF = ROOT / "impact_tpu"
PORT = ROOT / "impact_tpu_torch"
APPS = ROOT / "apps"

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
    "render/lights.py:render_omni_shadow_cubemap(backend)":
        "defaults to the K1 kernel (\"kernel\"), where the reference's default is its XLA raster",
    "render/lights.py:render_uni_shadow_map(backend)":
        "defaults to the K1 kernel (\"kernel\"), where the reference's default is its XLA raster",
    "render/lights.py:render_uni_shadow_cascades(backend)":
        "defaults to the K1 kernel (\"kernel\"), where the reference's default is its XLA raster",
    "render/pipeline.py:RenderConfig.raster_backend":
        "defaults to \"kernel\" (K1), where the reference's default is \"xla\"",
    "utils/config.py:TpuConfig.raster_backend":
        "defaults to \"kernel\" (K1), where the reference's default is \"auto\"; "
        "the reference's names read as the port's",
    "render/raster_pallas.py:rasterize_attributes(interpret)":
        "no interpret flag: a CPU tensor runs K1's plain version",
    "render/raster_pallas.py:rasterize_attributes_pos(interpret)":
        "no interpret flag: a CPU tensor runs K1's plain version",
    "render/raster_pallas.py:rasterize_depth(interpret)":
        "no interpret flag: a CPU tensor runs K1's plain version",
    "render/raster_pallas.py:rasterize_depth_pos(interpret)":
        "no interpret flag: a CPU tensor runs K1's plain version",
    "apps/parity_snapshots.py:force_cpu":
        "sets JAX's platform; the port's harness takes device= instead",
    "apps/parity_snapshots.py:run":
        "takes no update_dir, which the reference harness takes and never reads",
}

FUNCTIONS = (ast.FunctionDef, ast.AsyncFunctionDef)
KINDS = ("staticmethod", "classmethod", "property")


def _modules():
    """The reference's modules (paths under ``impact_tpu/``) and the root
    apps (``apps/NAME.py``)."""
    return (sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))
            + sorted(f"apps/{p.name}" for p in APPS.glob("*.py")))


def _reference_path(rel):
    return ROOT / rel if rel.startswith("apps/") else REF / rel


_TREES = {}


def _tree(path):
    if path not in _TREES:
        _TREES[path] = ast.parse(path.read_text())
    return _TREES[path]


def _surface(path):
    """(defs and classes {name: node}, the names the module defines, the
    names it defines or imports, ``__all__`` or None) of one module."""
    tree = _tree(path)
    defs, names, imported, exported = {}, set(), set(), None
    for node in tree.body:
        if isinstance(node, (*FUNCTIONS, ast.ClassDef)):
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
    if not isinstance(node, FUNCTIONS):
        return None
    return [a.arg for a in node.args.posonlyargs + node.args.args]


def _import_path(path, node):
    """The module file a ``from X import ...`` in ``path`` names, within
    the repo, or None."""
    if node.level:
        base = path.parents[node.level - 1]
        parts = node.module.split(".") if node.module else []
    else:
        parts = (node.module or "").split(".")
        base = ROOT
    target = base.joinpath(*parts)
    for cand in (target.with_suffix(".py"), target / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _constants(path, seen=()):
    """{name: repr of its literal} of the module's literal constants,
    those it imports from the repo's modules included."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, ast.ImportFrom) and path not in seen:
            src = _import_path(path, node)
            if src is not None:
                consts = _constants(src, (*seen, path))
                out.update({a.asname or a.name: consts[a.name] for a in node.names
                            if a.name in consts})
        elif isinstance(node, ast.Assign) and len(node.targets) == 1:
            t, v = node.targets[0], node.value
            pairs = ([(t, v)] if isinstance(t, ast.Name) else
                     list(zip(t.elts, v.elts)) if isinstance(t, ast.Tuple)
                     and isinstance(v, ast.Tuple) and len(t.elts) == len(v.elts) else [])
            for name, value in pairs:
                try:
                    out[name.id] = repr(ast.literal_eval(value))
                except (ValueError, TypeError, SyntaxError, AttributeError):
                    pass
    return out


def _value(node, consts):
    """A default as compared: its literal, a module constant's literal, or
    its source with ``jnp.`` read as ``torch.``."""
    try:
        return repr(ast.literal_eval(node))
    except (ValueError, TypeError, SyntaxError):
        pass
    if isinstance(node, ast.Name) and node.id in consts:
        return consts[node.id]
    return ast.unparse(node).replace("jnp.", "torch.")


def _defaults(fn, consts):
    """{parameter: its default as compared} and the keyword-only names."""
    a = fn.args
    pos = a.posonlyargs + a.args
    out = {p.arg: _value(d, consts) for p, d in zip(pos[len(pos) - len(a.defaults):], a.defaults)}
    out.update({p.arg: _value(d, consts) for p, d in zip(a.kwonlyargs, a.kw_defaults)
                if d is not None})
    return out, {p.arg for p in a.kwonlyargs}


def _params(fn):
    a = fn.args
    return {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs}


def _classes(tree):
    """{name: ClassDef} of the module's classes and its aliases of them."""
    out = {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}
    for n in tree.body:
        if isinstance(n, ast.Assign) and isinstance(n.value, ast.Name) and n.value.id in out:
            out.update({t.id: out[n.value.id] for t in n.targets if isinstance(t, ast.Name)})
    return out


def _kind(fn):
    for d in fn.decorator_list:
        name = ast.unparse(d)
        if name in KINDS:
            return name
        if name.endswith((".setter", ".deleter")):
            return "property"
    return "method"


def _members(cls):
    """{public member: its kind} of a class: its methods, properties,
    static and class methods and class attributes, and the names its
    methods assign to ``self``."""
    out = {}
    for n in ast.walk(cls):
        if isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in targets:
                if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    out[t.attr] = "attribute"
    for n in cls.body:
        if isinstance(n, FUNCTIONS):
            out[n.name] = _kind(n)
        elif isinstance(n, ast.ClassDef):
            out[n.name] = "class"
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out.update({t.id: "attribute" for t in targets if isinstance(t, ast.Name)})
    return {k: v for k, v in out.items() if not k.startswith("_")}


def _fields(cls, consts):
    """[(field, its default as compared or None)] of a NamedTuple or a
    dataclass, else None."""
    marks = [ast.unparse(b) for b in cls.bases] + [ast.unparse(d) for d in cls.decorator_list]
    if not any(m.split("(")[0].split(".")[-1] in ("NamedTuple", "dataclass") for m in marks):
        return None
    return [(n.target.id, None if n.value is None else _value(n.value, consts))
            for n in cls.body if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)
            and "ClassVar" not in ast.unparse(n.annotation)]


def _signature_differences(key, ref_fn, port_fn, ref_consts, port_consts):
    """The keys of a same-named function or method whose parameters
    differ: ``key`` where the positional ones do, else ``key(parameter)``
    for each keyword-only parameter the port lacks and each default that
    differs."""
    a, b = _positional(ref_fn), _positional(port_fn)
    if b[:len(a)] != a:
        return {key}
    ref_defaults, ref_kwonly = _defaults(ref_fn, ref_consts)
    port_defaults, _ = _defaults(port_fn, port_consts)
    out = {f"{key}({p})" for p in ref_kwonly - _params(port_fn)}
    out |= {f"{key}({p})" for p, v in ref_defaults.items() if port_defaults.get(p) != v}
    for star in ("vararg", "kwarg"):
        if getattr(ref_fn.args, star) is not None and getattr(port_fn.args, star) is None:
            out.add(f"{key}(*{getattr(ref_fn.args, star).arg})")
    return out


def _class_differences(rel, name, ref_cls, port_cls, ref_consts, port_consts):
    out = set()
    ref_members, port_members = _members(ref_cls), _members(port_cls)
    out |= {f"{rel}:{name}.{m}" for m, kind in ref_members.items()
            if port_members.get(m) != kind}
    ref_fields, port_fields = _fields(ref_cls, ref_consts), _fields(port_cls, port_consts)
    if ref_fields is not None:
        if [f for f, _ in ref_fields] != [f for f, _ in port_fields or ()]:
            out.add(f"{rel}:{name}(fields)")
        else:
            out |= {f"{rel}:{name}.{f}" for (f, a), (_, b) in zip(ref_fields, port_fields)
                    if a != b}
    port_methods = {n.name: n for n in port_cls.body if isinstance(n, FUNCTIONS)}
    for m in ref_cls.body:
        if (isinstance(m, FUNCTIONS) and (m.name == "__init__" or not m.name.startswith("_"))
                and m.name in port_methods):
            out |= _signature_differences(f"{rel}:{name}.{m.name}", m, port_methods[m.name],
                                          ref_consts, port_consts)
    return out


def _differences(rel):
    """What of reference module ``rel`` the port lacks or has otherwise:
    the keys of ``DIFFERENCES``' form."""
    ref_path = _reference_path(rel)
    ref_defs, ref_names, _, ref_all = _surface(ref_path)
    port_path = PORT / rel
    if not port_path.exists():
        return {f"{rel}:(module)"}
    port_defs, _, port_names, port_all = _surface(port_path)
    ref_consts, port_consts = _constants(ref_path), _constants(port_path)
    wanted = {n for n in ref_names if not n.startswith("_")} | set(ref_all or ())
    out = {f"{rel}:{n}" for n in wanted if n not in port_names}
    for name, node in ref_defs.items():
        if name.startswith("_") or name not in port_defs or not isinstance(node, FUNCTIONS):
            continue
        if not isinstance(port_defs[name], FUNCTIONS):
            out.add(f"{rel}:{name}")
            continue
        out |= _signature_differences(f"{rel}:{name}", node, port_defs[name], ref_consts,
                                      port_consts)
    ref_classes, port_classes = _classes(_tree(ref_path)), _classes(_tree(port_path))
    for name, cls in ref_classes.items():
        if name.startswith("_") or name not in port_names:
            continue
        if name not in port_classes:
            out.add(f"{rel}:{name}")
            continue
        out |= _class_differences(rel, name, cls, port_classes[name], ref_consts, port_consts)
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
        assert f"`{key}`" in queue3, key


def test_the_walk_sees_members_fields_and_defaults():
    """The walk's own checks, on two small modules: a missing member, a
    member of another kind, fields out of order, a field default, a
    keyword-only flag and a default that differs each give their key;
    a module constant reads as its literal and jnp as torch."""
    ref = ast.parse(
        "import jax.numpy as jnp\nRATE = 0.8\n"
        "class Iso(NamedTuple):\n    a: int\n    b: int = 0\n"
        "    @staticmethod\n    def identity(dtype=jnp.float32): ...\n"
        "    @property\n    def n(self): ...\n"
        "def f(x, r=RATE, *, interpret=False): ...\n"
        "def g(x, r=RATE): ...\n")
    port = ast.parse(
        "import torch\n"
        "class Iso(NamedTuple):\n    b: int\n    a: int\n"
        "    def identity(dtype=torch.float32): ...\n"
        "def f(x, r=0.8): ...\n"
        "def g(x, r=0.7): ...\n")
    ref_consts, port_consts = {"RATE": "0.8"}, {}
    cls = _class_differences("m.py", "Iso", _classes(ref)["Iso"], _classes(port)["Iso"],
                             ref_consts, port_consts)
    assert cls == {"m.py:Iso.identity", "m.py:Iso.n", "m.py:Iso(fields)"}
    fns = [n for n in ref.body if isinstance(n, FUNCTIONS)]
    pfns = [n for n in port.body if isinstance(n, FUNCTIONS)]
    assert _signature_differences("m.py:f", fns[0], pfns[0], ref_consts, port_consts) == {
        "m.py:f(interpret)"}
    assert _signature_differences("m.py:g", fns[1], pfns[1], ref_consts, port_consts) == {
        "m.py:g(r)"}
    ordered = ast.parse("class Iso(NamedTuple):\n    a: int\n    b: int\n")
    assert _class_differences("m.py", "Iso", _classes(ref)["Iso"], _classes(ordered)["Iso"],
                              ref_consts, port_consts) >= {"m.py:Iso.b"}
    assert _value(ast.parse("jnp.int32").body[0].value, {}) == "torch.int32"


def _device_defaults_to_none(path):
    """The public functions and methods of a port module whose ``device``
    parameter defaults to None."""
    out = []
    for node in ast.walk(_tree(path)):
        if isinstance(node, FUNCTIONS) and not node.name.startswith("_"):
            defaults, _ = _defaults(node, {})
            if defaults.get("device") == "None":
                out.append(f"{path.relative_to(ROOT)}:{node.lineno} {node.name}")
    return out


def test_no_public_function_defaults_device_to_none():
    """Entry points run on the card unless the caller asks for the CPU."""
    found = [f for p in sorted(PORT.rglob("*.py")) for f in _device_defaults_to_none(p)]
    assert found == []


def test_new_modules_are_imported_with_jax_blocked():
    from test_torch_no_jax import MODULES

    for m in ("impact_tpu_torch.utils.jpeg", "impact_tpu_torch.utils.image",
              "impact_tpu_torch.geometry", "impact_tpu_torch.math", "impact_tpu_torch.ops",
              "impact_tpu_torch.physics", "impact_tpu_torch.render", "impact_tpu_torch.voxel",
              "impact_tpu_torch.scene"):
        assert m in MODULES, m
