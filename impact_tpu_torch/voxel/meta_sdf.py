"""Meta-SDF graphs: stochastic composition of atomic SDF graphs (port of
``impact_tpu/voxel/meta_sdf.py``; ref: impact_voxel
src/generation/sdf/meta.rs and meta/params.rs).

The reference's MetaSDFGraph resolves nodes into three output kinds —
Instances (shapes with similarity transforms), SDFGroup and SingleSDF —
through instance primitives, instance transforms (basic, structured and
SDF-surface-relative), stochastic selection, instantiation, noise
modification and boolean combination. Every numeric parameter is drawn from
a distribution spec that may depend on other parameters of the same node
(params.rs ContParamSpec/DiscreteParamSpec with FromParam value sources and
topological evaluation order).

Meta graphs are nested Python dicts resolved with numpy on the host at
scene build (the reference samples on the CPU too). ``lower`` emits the
atomic dict graphs of ``voxel/sdf.py``, which ``sdf.evaluate`` then runs on
the device. The sampling, the seeding and the host evaluator are the
reference package's own, so a meta node and a seed lower to the same dict
in both packages. Surface-relative placement (ClosestTranslationToSurface,
RayTranslationToSurface, RotationToGradient; meta.rs:485-523, 2411-2726)
samples the lowered SDF with ``sdf.evaluate_np``.

A meta node is a dict {"kind": "meta_*", ...}; ``lower`` resolves it.
"""

from __future__ import annotations

import numpy as np

from . import sdf as atomic

# =============================================================================
# Parameter distributions (ref: meta/params.rs)
# =============================================================================
#
# A spec is a number (fixed constant) or a dict {"dist": ..., **sources}.
# A value source is a number or {"param": other_field, "offset": o, "scale": s}
# (ref: params.rs ContValueSource::FromParam + ParamValueMapping::Linear),
# which makes one parameter's distribution depend on another parameter of the
# same node; evaluation is topologically ordered with cycle detection
# (params.rs compute_param_eval_order).


def constant(v):
    return {"dist": "constant", "value": v}


def uniform(lo, hi):
    return {"dist": "uniform", "lo": lo, "hi": hi}


def normal(mean, stddev):
    return {"dist": "normal", "mean": mean, "stddev": stddev}


def uniform_cos_angle(min_angle, max_angle):
    """Angles (degrees) distributed uniformly in cos(angle)
    (ref: params.rs ContParamSpec::UniformCosAngle)."""
    return {"dist": "uniform_cos_angle", "min_angle": min_angle, "max_angle": max_angle}


def power_law(lo, hi, exponent):
    """Power-law in [lo, hi] (ref: params.rs ContParamSpec::PowerLaw +
    impact_math random/power_law.rs inverse-CDF sampling)."""
    return {"dist": "power_law", "lo": lo, "hi": hi, "exponent": exponent}


def discrete_uniform(lo, hi):
    """Integer uniform in [lo, hi] (ref: params.rs DiscreteParamSpec::Uniform)."""
    return {"dist": "discrete_uniform", "lo": lo, "hi": hi}


def from_param(name, offset=0.0, scale=1.0):
    """Value source referencing another parameter of the same node
    (ref: params.rs FromParam{idx, Linear{offset, scale}})."""
    return {"param": str(name), "offset": float(offset), "scale": float(scale)}


def _src_deps(src):
    return [src["param"]] if isinstance(src, dict) else []


def _src_eval(src, values):
    if isinstance(src, dict):
        return src["offset"] + src["scale"] * values[src["param"]]
    return float(src)


def _spec_deps(spec):
    if not isinstance(spec, dict):
        return []
    if "param" in spec:  # bare value source used as a whole spec
        return _src_deps(spec)
    deps = []
    for key, v in spec.items():
        if key != "dist":
            deps.extend(_src_deps(v))
    return deps


def _spec_sample(spec, values, rng: np.random.Generator):
    if not isinstance(spec, dict):
        return float(spec)
    if "param" in spec:  # bare value source used as a whole spec
        return _src_eval(spec, values)
    kind = spec["dist"]
    if kind == "constant":
        return _src_eval(spec["value"], values)
    if kind == "uniform":
        lo = _src_eval(spec["lo"], values)
        hi = max(_src_eval(spec["hi"], values), lo)
        return float(rng.uniform(lo, hi))
    if kind == "normal":
        return float(rng.normal(_src_eval(spec["mean"], values),
                                max(_src_eval(spec["stddev"], values), 0.0)))
    if kind == "uniform_cos_angle":
        amin = np.clip(np.deg2rad(_src_eval(spec["min_angle"], values)), 0.0, np.pi)
        amax = np.clip(np.deg2rad(_src_eval(spec["max_angle"], values)), amin, np.pi)
        c = rng.uniform(np.cos(amax), np.cos(amin))
        return float(np.rad2deg(np.arccos(np.clip(c, -1.0, 1.0))))
    if kind == "power_law":
        lo = max(_src_eval(spec["lo"], values), 1e-12)
        hi = max(_src_eval(spec["hi"], values), lo)
        e = _src_eval(spec["exponent"], values)
        u = rng.uniform()
        # inverse CDF of p(x) ∝ x^e on [lo, hi]
        if abs(e + 1.0) < 1e-6:
            return float(lo * (hi / lo) ** u)
        a, b = lo ** (e + 1.0), hi ** (e + 1.0)
        return float((a + u * (b - a)) ** (1.0 / (e + 1.0)))
    if kind == "discrete_uniform":
        lo = int(round(max(_src_eval(spec["lo"], values), 0.0)))
        hi = max(int(round(_src_eval(spec["hi"], values))), lo)
        return float(rng.integers(lo, hi + 1))
    raise ValueError(f"unknown distribution {kind!r}")


def sample_params(specs: dict, rng: np.random.Generator) -> dict:
    """Sample one value per named spec, honouring inter-parameter dependencies
    (ref: params.rs evaluate_params_for_node)."""
    order, state = [], {}

    def visit(name):
        st = state.get(name)
        if st == "done":
            return
        if st == "visiting":
            raise ValueError(f"circular parameter dependency involving {name!r}")
        if name not in specs:
            raise ValueError(f"parameter dependency on unknown field {name!r}")
        state[name] = "visiting"
        for dep in _spec_deps(specs[name]):
            visit(dep)
        state[name] = "done"
        order.append(name)

    for name in specs:
        visit(name)
    values = {}
    for name in order:
        values[name] = _spec_sample(specs[name], values, rng)
    return values


# =============================================================================
# Similarity transforms + quaternions (host-side numpy)
# =============================================================================


def _q_ident():
    return np.array([0.0, 0.0, 0.0, 1.0], np.float64)


def _q_mul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def _q_rot(q, v):
    u, w = q[:3], q[3]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def _q_conj(q):
    return q * np.array([-1.0, -1.0, -1.0, 1.0])


def _q_axis_angle(axis, angle):
    h = 0.5 * angle
    return np.concatenate([np.asarray(axis) * np.sin(h), [np.cos(h)]])


def _q_between(a, b):
    """Quaternion rotating unit vector a onto unit vector b."""
    c = float(np.dot(a, b))
    if c < -1.0 + 1e-8:  # antiparallel: 180° about any perpendicular axis
        axis = np.cross(a, [0.0, 0.0, 1.0] if abs(a[2]) < 0.9 else [1.0, 0.0, 0.0])
        axis = axis / np.linalg.norm(axis)
        return _q_axis_angle(axis, np.pi)
    axis = np.cross(a, b)
    q = np.concatenate([axis, [1.0 + c]])
    return q / np.linalg.norm(q)


class Sim:
    """Similarity transform p ↦ scale·R(p) + trans (ref: impact_math Similarity3)."""

    __slots__ = ("scale", "quat", "trans")

    def __init__(self, scale=1.0, quat=None, trans=(0.0, 0.0, 0.0)):
        self.scale = float(scale)
        self.quat = _q_ident() if quat is None else np.asarray(quat, np.float64)
        self.trans = np.asarray(trans, np.float64)

    def compose(self, other: "Sim") -> "Sim":
        """self ∘ other (apply other, then self)."""
        return Sim(
            self.scale * other.scale,
            _q_mul(self.quat, other.quat),
            self.scale * _q_rot(self.quat, other.trans) + self.trans,
        )

    def point(self, p):
        return self.scale * _q_rot(self.quat, np.asarray(p, np.float64)) + self.trans

    def vector(self, v):
        return self.scale * _q_rot(self.quat, np.asarray(v, np.float64))

    def translated(self, v):
        return Sim(self.scale, self.quat, self.trans + np.asarray(v))

    def rotated(self, q):
        return Sim(self.scale, _q_mul(q, self.quat), _q_rot(q, self.trans))

    def scaled(self, k):
        return Sim(k * self.scale, self.quat, k * self.trans)

    def pre_translated(self, v):  # ref: applied_to_translation
        return Sim(self.scale, self.quat, self.point(v))

    def pre_rotated(self, q):  # ref: applied_to_rotation
        return Sim(self.scale, _q_mul(self.quat, q), self.trans)

    def pre_scaled(self, k):  # ref: applied_to_scaling
        return Sim(self.scale * k, self.quat, self.trans)


class Instance:
    """A shape (or shapeless point) with a similarity transform
    (ref: meta.rs Instance/InstanceShape)."""

    __slots__ = ("shape", "sim")

    def __init__(self, shape=None, sim=None):
        self.shape = shape  # None | {"type": "sphere"/"capsule"/"box", ...}
        self.sim = sim if sim is not None else Sim()

    def with_sim(self, sim):
        return Instance(self.shape, sim)

    def applied(self, sim):  # ref: with_applied_transform (pre-multiplied)
        return Instance(self.shape, sim.compose(self.sim))


def _tilt_turn_roll_quat(tilt_deg, turn_deg, roll_deg):
    """Ref: meta.rs unit_quaternion_from_tilt_turn_roll."""
    polar, azim, roll = np.deg2rad([tilt_deg, turn_deg, roll_deg])
    d = np.array([
        np.sin(polar) * np.cos(azim), np.cos(polar), np.sin(polar) * np.sin(azim)
    ])
    q = _q_between(np.array([0.0, 1.0, 0.0]), d)
    return _q_mul(_q_axis_angle(d, roll), q)


# =============================================================================
# Node constructors (dict schema; kinds all prefixed "meta_")
# =============================================================================


def meta_points(count=1):
    """Shapeless identity-transform instances (ref: meta.rs MetaPoints)."""
    return {"kind": "meta_points", "count": int(count)}


def meta_spheres(radius=1.0, center=(0.0, 0.0, 0.0), count=None, seed=0,
                 sampling="per_instance"):
    """Sphere instance collection with distribution-sampled radius/center
    (ref: meta.rs MetaSpheres)."""
    return {"kind": "meta_spheres", "radius": radius,
            "center": tuple(center), "count": count, "seed": int(seed),
            "sampling": sampling}


def meta_boxes(extent=None, extents=None, center=(0.0, 0.0, 0.0), count=None,
               seed=0, sampling="per_instance"):
    """Box instance collection (ref: meta.rs MetaBoxes). ``extent`` is sugar
    for a cube; ``extents`` gives per-axis specs."""
    if extents is None:
        e = 1.0 if extent is None else extent
        extents = (e, e, e)
    return {"kind": "meta_boxes", "extents": tuple(extents),
            "center": tuple(center), "count": count, "seed": int(seed),
            "sampling": sampling}


def meta_capsules(radius=0.5, segment_length=1.0, center=(0.0, 0.0, 0.0),
                  count=None, seed=0, sampling="per_instance"):
    return {"kind": "meta_capsules", "radius": radius,
            "segment_length": segment_length, "center": tuple(center),
            "count": count, "seed": int(seed), "sampling": sampling}


def meta_translation(child, translation=(0.0, 0.0, 0.0), composition="post",
                     seed=0, sampling="per_instance"):
    return {"kind": "meta_translation", "child": child,
            "translation": tuple(translation), "composition": composition,
            "seed": int(seed), "sampling": sampling}


def meta_rotation(child, tilt=0.0, turn=0.0, roll=0.0, composition="post",
                  seed=0, sampling="per_instance"):
    """Tilt/turn/roll rotation of instances, degrees (ref: MetaRotation)."""
    return {"kind": "meta_rotation", "child": child, "tilt": tilt,
            "turn": turn, "roll": roll, "composition": composition,
            "seed": int(seed), "sampling": sampling}


def meta_scaling(child, scaling=1.0, composition="post", seed=0,
                 sampling="per_instance"):
    return {"kind": "meta_scaling", "child": child, "scaling": scaling,
            "composition": composition, "seed": int(seed), "sampling": sampling}


def meta_similarity(child, scale=1.0, tilt=0.0, turn=0.0, roll=0.0,
                    translation=(0.0, 0.0, 0.0), composition="post", seed=0,
                    sampling="per_instance"):
    return {"kind": "meta_similarity", "child": child, "scale": scale,
            "tilt": tilt, "turn": turn, "roll": roll,
            "translation": tuple(translation), "composition": composition,
            "seed": int(seed), "sampling": sampling}


def stratified_grid_transforms(child, shape=(3, 3, 3), cell_size=None,
                               cell_extents=None, jitter=0.5, scale=None,
                               seed=0):
    """Translate instances to jittered stratified-grid points
    (ref: meta.rs MetaStratifiedGridTransforms). ``shape`` entries and
    ``cell_extents``/``jitter`` may be distribution specs. ``cell_size``
    (scalar sugar) and ``scale`` (per-instance scaling sugar) keep the
    legacy call shape."""
    if cell_extents is None:
        c = 2.0 if cell_size is None else cell_size
        cell_extents = (c, c, c)
    node = {"kind": "meta_stratified_grid", "child": child,
            "shape": tuple(shape), "cell_extents": tuple(cell_extents),
            "jitter": jitter, "seed": int(seed)}
    if scale is not None and scale != 1.0:
        node["child"] = meta_scaling(child, scaling=scale, seed=seed + 1)
    return node


def sphere_surface_transforms(child, count=None, sphere_radius=5.0, jitter=0.0,
                              rotation="identity", scale=None, seed=0):
    """Translate instances onto a sphere surface with optional radial rotation
    (ref: meta.rs MetaSphereSurfaceTransforms; rotation ∈ identity /
    radial_outwards / radial_inwards)."""
    node = {"kind": "meta_sphere_surface", "child": child, "count": count,
            "radius": sphere_radius, "jitter": jitter, "rotation": rotation,
            "seed": int(seed)}
    if scale is not None and scale != 1.0:
        node["child"] = meta_scaling(child, scaling=scale, seed=seed + 1)
    return node


def closest_translation_to_surface(surface, subject):
    """Translate subject instances to the closest point on the surface of the
    SDF input (ref: meta.rs MetaClosestTranslationToSurface; Newton-Raphson,
    meta.rs:2411-2479)."""
    return {"kind": "meta_closest_translation_to_surface",
            "surface": surface, "subject": subject}


def ray_translation_to_surface(surface, subject, anchor="origin"):
    """Translate subject instances along their y-axes until the anchor
    (origin or shape boundary) reaches the SDF surface
    (ref: meta.rs MetaRayTranslationToSurface; spherecast, meta.rs:2534-2726)."""
    return {"kind": "meta_ray_translation_to_surface", "surface": surface,
            "subject": subject, "anchor": anchor}


def rotation_to_gradient(gradient_sdf, subject):
    """Rotate subject instances so their y-axis aligns with the SDF gradient
    at their position (ref: meta.rs MetaRotationToGradient)."""
    return {"kind": "meta_rotation_to_gradient", "gradient_sdf": gradient_sdf,
            "subject": subject}


def stochastic_selection(child, keep_probability=None, pick_probability=1.0,
                         min_pick_count=None, max_pick_count=None, seed=0):
    """Random selection from a group: draw a count in [min, max], take a
    random subset, keep each member with ``pick_probability``
    (ref: meta.rs MetaStochasticSelection). ``keep_probability`` is legacy
    sugar for pick_probability with an all-items subset."""
    if keep_probability is not None:
        pick_probability = keep_probability
    return {"kind": "meta_stochastic_selection", "child": child,
            "pick_probability": float(pick_probability),
            "min_pick_count": min_pick_count, "max_pick_count": max_pick_count,
            "seed": int(seed)}


def sdf_instantiation(child):
    """Instances → SDFGroup via their shapes+transforms
    (ref: meta.rs MetaSDFInstantiation)."""
    return {"kind": "meta_sdf_instantiation", "child": child}


def transform_application(sdf, instances):
    """Apply instance transforms to SDF(s), all combinations → SDFGroup
    (ref: meta.rs MetaTransformApplication)."""
    return {"kind": "meta_transform_application", "sdf": sdf,
            "instances": instances}


def noise_modifier(child, octaves=4, frequency=0.2, lacunarity=2.0,
                   persistence=0.5, amplitude=1.0, seed=0, sampling="per_sdf"):
    """Multifractal-noise perturbation with distribution-sampled parameters
    (ref: meta.rs MetaMultifractalNoiseSDFModifier)."""
    return {"kind": "meta_noise", "child": child, "octaves": octaves,
            "frequency": frequency, "lacunarity": lacunarity,
            "persistence": persistence, "amplitude": amplitude,
            "seed": int(seed), "sampling": sampling}


def sdf_union(a, b, smoothness=0.0):
    return {"kind": "meta_sdf_union", "children": [a, b],
            "smoothness": float(smoothness)}


def sdf_subtraction(a, b, smoothness=0.0):
    return {"kind": "meta_sdf_subtraction", "children": [a, b],
            "smoothness": float(smoothness)}


def sdf_intersection(a, b, smoothness=0.0):
    return {"kind": "meta_sdf_intersection", "children": [a, b],
            "smoothness": float(smoothness)}


def group_union(children, smoothness=0.0):
    """Balanced smooth union of children (ref: meta.rs MetaSDFGroupUnion +
    emit_balanced_binary_tree). Accepts a single group node or a list of
    meta/atomic nodes."""
    return {"kind": "meta_group_union", "smoothness": float(smoothness),
            "children": list(children) if isinstance(children, (list, tuple))
            else [children]}


# =============================================================================
# Lowering
# =============================================================================

_NODE_TAGS = {
    "meta_points": 0x00, "meta_spheres": 0x01, "meta_capsules": 0x02,
    "meta_boxes": 0x03, "meta_translation": 0x10, "meta_rotation": 0x11,
    "meta_scaling": 0x12, "meta_similarity": 0x13,
    "meta_stratified_grid": 0x14, "meta_sphere_surface": 0x15,
    "meta_closest_translation_to_surface": 0x20,
    "meta_ray_translation_to_surface": 0x21, "meta_rotation_to_gradient": 0x22,
    "meta_stochastic_selection": 0x30, "meta_sdf_instantiation": 0x40,
    "meta_transform_application": 0x41, "meta_noise": 0x50,
    "meta_sdf_union": 0x60, "meta_sdf_subtraction": 0x61,
    "meta_sdf_intersection": 0x62, "meta_group_union": 0x63,
}


def _splitmix64(x):
    """Ref: impact_math splitmix (stable per-node seed mixing, meta.rs:993)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def _mix(*xs):
    h = 0
    for x in xs:
        h = _splitmix64(h ^ _splitmix64(int(x) & 0xFFFFFFFFFFFFFFFF))
    return h


def _children_of(node):
    kind = node.get("kind", "")
    if kind in ("meta_closest_translation_to_surface",
                "meta_ray_translation_to_surface"):
        return [node["surface"], node["subject"]]
    if kind == "meta_rotation_to_gradient":
        return [node["gradient_sdf"], node["subject"]]
    if kind == "meta_transform_application":
        return [node["sdf"], node["instances"]]
    if "children" in node:
        return list(node["children"])
    if "child" in node:
        return [node["child"]]
    return []


def _stable_seed(node):
    """Seed that only changes with the subgraph's types/topology/seeding
    (ref: meta.rs obtain_stable_seed)."""
    kind = node.get("kind", "")
    if not kind.startswith("meta_"):
        return _mix(0xA70)  # atomic leaf
    tag = _NODE_TAGS[kind]
    parts = [tag, int(node.get("seed", 0))]
    parts.extend(_stable_seed(c) for c in _children_of(node))
    return _mix(*parts)


class _Out:
    """Resolved node output (ref: meta.rs MetaSDFNodeOutput)."""

    def __init__(self, kind, value):
        self.kind = kind  # "sdf" | "group" | "instances"
        self.value = value

    @classmethod
    def sdf(cls, graph_or_none):
        return cls("sdf", graph_or_none)

    @classmethod
    def group(cls, graphs):
        return cls("group", list(graphs))

    @classmethod
    def instances(cls, insts):
        return cls("instances", list(insts))


def lower(node, seed: int = 0, smoothness: float = 0.0, scale_factor: float = 1.0):
    """Lower a meta graph to an atomic SDF dict graph
    (ref: meta.rs MetaSDFGraph::build_in). Instance/group roots are
    auto-instantiated and group-unioned with ``smoothness``."""
    out = _resolve(node, int(seed), float(scale_factor))
    if out.kind == "instances":
        out = _instantiate(out.value, float(scale_factor))
    if out.kind == "group":
        return _balanced_union(out.value, smoothness)
    if out.value is None:
        # empty output: a far-away point (+large near the domain)
        return atomic.translation(atomic.sphere(1e-3), (1e6, 1e6, 1e6))
    return out.value


def _resolve(node, build_seed, sf) -> _Out:
    kind = node.get("kind", "")
    if not kind.startswith("meta_"):
        return _Out.sdf(node)  # already atomic
    node_seed = _mix(build_seed, _stable_seed(node))
    rng = np.random.default_rng(node_seed)

    child_outs = [_resolve(c, build_seed, sf) for c in _children_of(node)]

    fn = _RESOLVERS.get(kind)
    if fn is None:
        raise ValueError(f"unknown meta node kind {kind!r}")
    return fn(node, child_outs, rng, sf)


# --- helpers ------------------------------------------------------------------


def _expect(out, want, what):
    if out.kind != want:
        raise ValueError(f"{what} expects {want} input, got {out.kind}")
    return out.value


def _as_single_sdf(out, what):
    """Coerce an SDF or SDFGroup output to one SDF graph (None if empty);
    groups union together (ref: meta.rs group→single coercion via union)."""
    if out.kind == "sdf":
        return out.value
    if out.kind == "group":
        return _balanced_union(out.value, 0.0) if out.value else None
    raise ValueError(f"{what} expects an SDF as input 1, got {out.kind}")


def _per_instance_loop(node, insts, rng, specs, apply_one):
    """Shared once/per-instance sampling loop
    (ref: meta.rs resolve_unary_instance_op)."""
    once = node.get("sampling", "per_instance") in ("once", "only_once")
    params = sample_params(specs, rng)
    out = []
    for i, inst in enumerate(insts):
        out.append(apply_one(params, inst))
        if not once and i + 1 < len(insts):
            params = sample_params(specs, rng)
    return out


def _instantiate(insts, sf):
    """Instances → SDFGroup (ref: meta.rs MetaSDFInstantiation::resolve)."""
    graphs = []
    for inst in insts:
        if inst.shape is None:
            continue
        t = inst.shape["type"]
        if t == "sphere":
            g = atomic.sphere(max(inst.shape["radius"], 1e-4))
        elif t == "capsule":
            g = atomic.capsule(max(inst.shape["radius"], 1e-4),
                               max(inst.shape["segment_length"], 1e-4))
        else:
            g = atomic.box(tuple(max(e, 1e-4) for e in inst.shape["extents"]))
        center = np.asarray(inst.shape.get("center", (0.0, 0.0, 0.0)))
        if np.any(center != 0.0):
            g = atomic.translation(g, tuple(center))
        sim = inst.sim
        if abs(sim.scale - 1.0) > 1e-9:
            g = atomic.scaling(g, sim.scale)
        if np.linalg.norm(sim.quat - _q_ident()) > 1e-9:
            g = atomic.rotation(g, tuple(float(x) for x in sim.quat))
        if np.any(np.abs(sim.trans) > 1e-12):
            g = atomic.translation(g, tuple(float(x) for x in sim.trans))
        graphs.append(g)
    return _Out.group(graphs)


def _balanced_union(graphs, smoothness):
    """Balanced binary union tree (ref: meta.rs emit_balanced_binary_tree) —
    a log-depth graph evaluates with a shorter chain of dependent tensor
    operations than the left-leaning fold."""
    if not graphs:
        return atomic.translation(atomic.sphere(1e-3), (1e6, 1e6, 1e6))
    queue = list(graphs)
    while len(queue) > 1:
        a = queue.pop(0)
        b = queue.pop(0)
        queue.append(atomic.union(a, b, smoothness))
    return queue[0]


def _sample_sdf_gradient(graph, pos):
    """Signed distance + gradient from a 2×2×2 block one voxel apart
    (ref: meta.rs sample_signed_distance_with_gradient:2728-2770)."""
    offs = np.array([[i, j, k] for i in (-0.5, 0.5) for j in (-0.5, 0.5)
                     for k in (-0.5, 0.5)])
    d = atomic.evaluate_np(graph, pos[None, :] + offs).astype(np.float64)
    value = d.sum() * 0.125
    # d ordering: index = 4*i + 2*j + k with i≡x, j≡y, k≡z
    gx = (d[4] + d[5] + d[6] + d[7]) - (d[0] + d[1] + d[2] + d[3])
    gy = (d[2] + d[3] + d[6] + d[7]) - (d[0] + d[1] + d[4] + d[5])
    gz = (d[1] + d[3] + d[5] + d[7]) - (d[0] + d[2] + d[4] + d[6])
    return value, 0.25 * np.array([gx, gy, gz])


def _newton_to_surface(graph, start, max_iterations=5, tol=0.1):
    """Newton-Raphson walk to the zero isosurface
    (ref: meta.rs compute_translation_to_closest_point_on_surface)."""
    pos = np.asarray(start, np.float64).copy()
    for _ in range(max_iterations):
        d, g = _sample_sdf_gradient(graph, pos)
        g2 = float(g @ g)
        if g2 < 1e-8:
            return None
        pos += (-d / g2) * g
        if abs(d) <= tol:
            break
    return pos - start


def _aabb_ray_hit(lo, hi, origin, direction):
    """Slab test → (tmin, tmax) or None (ref: domain.find_ray_intersection)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / direction
        t1 = (lo - origin) * inv
        t2 = (hi - origin) * inv
    tmin = float(np.max(np.where(np.isnan(t1), -np.inf, np.minimum(t1, t2))))
    tmax = float(np.min(np.where(np.isnan(t2), np.inf, np.maximum(t1, t2))))
    if tmax < tmin:
        return None
    return tmin, tmax


def _smallest_distance_on_sphere(graph, radius, pos):
    """Signed distance of the sphere point closest to the surface
    (ref: meta.rs compute_smallest_signed_distance_on_sphere)."""
    if radius > 1e-9:
        _, g = _sample_sdf_gradient(graph, pos)
        gn = np.linalg.norm(g)
        if gn < 1e-8:
            return None
        pos = pos - radius * (g / gn)
    return float(atomic.evaluate_np(graph, pos[None, :])[0])


def _spherecast_to_surface(graph, sphere_center, sphere_radius, direction,
                           max_steps=128, tol=0.1, safety=0.5):
    """Sphere-march along a ray until the sphere boundary touches the surface
    (ref: meta.rs compute_spherecast_translation_to_surface_same_space)."""
    lo, hi = atomic.estimate_bounds(graph)
    hit = _aabb_ray_hit(lo.astype(np.float64), hi.astype(np.float64),
                        sphere_center, direction)
    if hit is None:
        return None
    start_t = hit[0] - sphere_radius
    max_t = hit[1]
    t = start_t
    pos = sphere_center + t * direction
    d = _smallest_distance_on_sphere(graph, sphere_radius, pos)
    if d is None or d < 0.0:  # already penetrating: treat as a miss
        return None
    crossed = False
    steps = 0
    while abs(d) > tol:
        steps += 1
        if steps >= max_steps:
            if crossed:
                break
            return None
        t += d * safety
        if d < 0.0:
            crossed = True
        if t > max_t or t < start_t:
            return None
        pos = sphere_center + t * direction
        d = _smallest_distance_on_sphere(graph, sphere_radius, pos)
        if d is None:
            return None
    return pos - sphere_center


def _fibonacci_directions(n):
    """Evenly distributed unit directions
    (ref: compute_uniformly_distributed_radial_directions)."""
    idx = np.arange(n) + 0.5
    phi = np.arccos(1.0 - 2.0 * idx / n)
    theta = np.pi * (1.0 + 5.0 ** 0.5) * idx
    return np.stack([np.sin(phi) * np.cos(theta), np.cos(phi),
                     np.sin(phi) * np.sin(theta)], axis=-1)


def _jittered_direction(direction, max_angle, rng):
    """Ref: meta.rs compute_jittered_direction."""
    if max_angle <= 1e-9:
        return direction
    angle = rng.uniform(0.0, max_angle)
    axis = rng.uniform(-1.0, 1.0, 3)
    axis -= (axis @ direction) * direction
    n = np.linalg.norm(axis)
    if n < 1e-8:
        base = np.array([0.0, 0.0, 1.0]) if abs(direction[2]) < 0.9 else \
            np.array([1.0, 0.0, 0.0])
        axis = base - (base @ direction) * direction
        n = np.linalg.norm(axis)
    axis /= n
    return _q_rot(_q_axis_angle(axis, angle), direction)


# --- per-kind resolvers ---------------------------------------------------------


def _r_points(node, outs, rng, sf):
    return _Out.instances([Instance() for _ in range(int(node["count"]))])


def _primitive_resolver(shape_of, spec_fields):
    def resolve(node, outs, rng, sf):
        count = node.get("count")
        count = 1 if count is None else int(count)
        specs = spec_fields(node)
        once = node.get("sampling", "per_instance") in ("once", "only_once")
        insts = []
        params = sample_params(specs, rng)
        for i in range(count):
            insts.append(Instance(shape=shape_of(params, sf)))
            if not once and i + 1 < count:
                params = sample_params(specs, rng)
        return _Out.instances(insts)
    return resolve


def _sphere_specs(node):
    cx, cy, cz = node.get("center", (0.0, 0.0, 0.0))
    return {"radius": node["radius"], "cx": cx, "cy": cy, "cz": cz}


def _sphere_shape(p, sf):
    return {"type": "sphere", "radius": p["radius"] * sf,
            "center": (p["cx"] * sf, p["cy"] * sf, p["cz"] * sf)}


def _capsule_specs(node):
    cx, cy, cz = node.get("center", (0.0, 0.0, 0.0))
    return {"radius": node["radius"], "segment_length": node["segment_length"],
            "cx": cx, "cy": cy, "cz": cz}


def _capsule_shape(p, sf):
    return {"type": "capsule", "radius": p["radius"] * sf,
            "segment_length": p["segment_length"] * sf,
            "center": (p["cx"] * sf, p["cy"] * sf, p["cz"] * sf)}


def _box_specs(node):
    ex, ey, ez = node["extents"]
    cx, cy, cz = node.get("center", (0.0, 0.0, 0.0))
    return {"ex": ex, "ey": ey, "ez": ez, "cx": cx, "cy": cy, "cz": cz}


def _box_shape(p, sf):
    return {"type": "box",
            "extents": (p["ex"] * sf, p["ey"] * sf, p["ez"] * sf),
            "center": (p["cx"] * sf, p["cy"] * sf, p["cz"] * sf)}


def _r_translation(node, outs, rng, sf):
    insts = _expect(outs[0], "instances", "meta_translation")
    tx, ty, tz = node["translation"]
    pre = node.get("composition", "post") == "pre"

    def apply_one(p, inst):
        v = np.array([p["tx"], p["ty"], p["tz"]]) * sf
        return inst.with_sim(inst.sim.pre_translated(v) if pre
                             else inst.sim.translated(v))

    return _Out.instances(_per_instance_loop(
        node, insts, rng, {"tx": tx, "ty": ty, "tz": tz}, apply_one))


def _r_rotation(node, outs, rng, sf):
    insts = _expect(outs[0], "instances", "meta_rotation")
    pre = node.get("composition", "post") == "pre"

    def apply_one(p, inst):
        q = _tilt_turn_roll_quat(p["tilt"], p["turn"], p["roll"])
        return inst.with_sim(inst.sim.pre_rotated(q) if pre
                             else inst.sim.rotated(q))

    return _Out.instances(_per_instance_loop(
        node, insts, rng,
        {"tilt": node["tilt"], "turn": node["turn"], "roll": node["roll"]},
        apply_one))


def _r_scaling(node, outs, rng, sf):
    insts = _expect(outs[0], "instances", "meta_scaling")
    pre = node.get("composition", "post") == "pre"

    def apply_one(p, inst):
        k = max(p["scaling"], 1e-7)
        return inst.with_sim(inst.sim.pre_scaled(k) if pre
                             else inst.sim.scaled(k))

    return _Out.instances(_per_instance_loop(
        node, insts, rng, {"scaling": node["scaling"]}, apply_one))


def _r_similarity(node, outs, rng, sf):
    insts = _expect(outs[0], "instances", "meta_similarity")
    tx, ty, tz = node["translation"]
    pre = node.get("composition", "post") == "pre"

    def apply_one(p, inst):
        sim = Sim(max(p["scale"], 1e-7),
                  _tilt_turn_roll_quat(p["tilt"], p["turn"], p["roll"]),
                  np.array([p["tx"], p["ty"], p["tz"]]) * sf)
        return inst.with_sim(inst.sim.compose(sim) if pre
                             else sim.compose(inst.sim))

    return _Out.instances(_per_instance_loop(
        node, insts, rng,
        {"scale": node["scale"], "tilt": node["tilt"], "turn": node["turn"],
         "roll": node["roll"], "tx": tx, "ty": ty, "tz": tz},
        apply_one))


def _resolve_child_count(node, outs, n_needed, rng, sf):
    """Legacy sugar: primitives without explicit count inherit the structured
    transform's instance count, with per-instance parameter re-sampling (the
    reference's primitive nodes sample each instance independently)."""
    insts = outs[0].value
    if len(insts) == 1 and n_needed > 1:
        child = node.get("child", {})
        if child.get("kind") in ("meta_spheres", "meta_boxes", "meta_capsules",
                                 "meta_points") and child.get("count") is None:
            expanded = dict(child, count=n_needed)
            insts = _RESOLVERS[child["kind"]](expanded, [], rng, sf).value
    return insts


def _r_stratified_grid(node, outs, rng, sf):
    _expect(outs[0], "instances", "meta_stratified_grid")
    sx, sy, sz = node["shape"]
    ex, ey, ez = node["cell_extents"]
    p = sample_params({"sx": sx, "sy": sy, "sz": sz, "ex": ex, "ey": ey,
                       "ez": ez, "jitter": node["jitter"]}, rng)
    shape = [max(int(round(p[k])), 0) for k in ("sx", "sy", "sz")]
    cells = np.array([max(p[k] * sf, 0.0) for k in ("ex", "ey", "ez")])
    jf = float(np.clip(p["jitter"], 0.0, 1.0))
    n_cells = shape[0] * shape[1] * shape[2]
    insts = _resolve_child_count(node, outs, n_cells, rng, sf)
    if not insts:
        return _Out.instances([])
    if n_cells == 0:
        return _Out.instances(list(insts))
    start = -0.5 * np.array(shape) * cells + 0.5 * cells
    out = []
    for idx, inst in enumerate(insts):
        cell = (idx * n_cells) // len(insts)
        i = cell // (shape[1] * shape[2])
        j = (cell // shape[2]) % shape[1]
        k = cell % shape[2]
        base = start + np.array([i, j, k]) * cells
        jit = rng.uniform(-0.5, 0.5, 3) * jf * cells
        out.append(inst.applied(Sim(trans=base + jit)))
    return _Out.instances(out)


def _r_sphere_surface(node, outs, rng, sf):
    _expect(outs[0], "instances", "meta_sphere_surface")
    p = sample_params({"radius": node["radius"], "jitter": node["jitter"]}, rng)
    radius = max(p["radius"] * sf, 0.0)
    jf = float(np.clip(p["jitter"], 0.0, 1.0))
    n_req = node.get("count")
    insts = _resolve_child_count(node, outs,
                                 int(n_req) if n_req else len(outs[0].value),
                                 rng, sf)
    if not insts:
        return _Out.instances([])
    count = len(insts)
    # jitter cap from the per-instance solid angle (ref: compute_max_jitter_angle)
    solid = 4.0 * np.pi / count
    max_polar = np.arccos(np.clip(1.0 - solid / (2.0 * np.pi), -1.0, 1.0))
    max_jitter = float(np.clip(jf * max_polar, 0.0, 0.5 * np.pi))
    mode = node.get("rotation", "identity")
    out = []
    for d, inst in zip(_fibonacci_directions(count), insts):
        dj = _jittered_direction(d, max_jitter, rng)
        if mode == "radial_outwards":
            q = _q_between(np.array([0.0, 1.0, 0.0]), dj)
        elif mode == "radial_inwards":
            q = _q_between(np.array([0.0, -1.0, 0.0]), dj)
        else:
            q = _q_ident()
        out.append(inst.applied(Sim(1.0, q, radius * dj)))
    return _Out.instances(out)


def _r_closest_translation(node, outs, rng, sf):
    insts = _expect(outs[1], "instances", "meta_closest_translation_to_surface")
    surface = _as_single_sdf(outs[0], "meta_closest_translation_to_surface")
    if surface is None:
        return _Out.instances(list(insts))
    out = []
    for inst in insts:
        delta = _newton_to_surface(surface, inst.sim.trans)
        if delta is None:
            continue
        out.append(inst.with_sim(inst.sim.translated(delta)))
    return _Out.instances(out)


def _sphere_for_shape(shape):
    """Anchor sphere for shape-boundary ray translation
    (ref: meta.rs sphere_for_shape:1745-1765; shape centers are ignored)."""
    if shape is None:
        return np.zeros(3), 0.0
    t = shape["type"]
    if t == "sphere":
        return np.zeros(3), shape["radius"]
    if t == "capsule":
        return np.array([0.0, 0.5 * shape["segment_length"], 0.0]), shape["radius"]
    ex, ey, ez = shape["extents"]
    r = 0.5 * min(ex, ey, ez)  # inscribed sphere
    return np.array([0.0, 0.5 * ey - r, 0.0]), r


def _r_ray_translation(node, outs, rng, sf):
    insts = _expect(outs[1], "instances", "meta_ray_translation_to_surface")
    surface = _as_single_sdf(outs[0], "meta_ray_translation_to_surface")
    if surface is None:
        return _Out.instances(list(insts))
    boundary = node.get("anchor", "origin") in ("shape_boundary",
                                                "shape_boundary_at_origin")
    out = []
    for inst in insts:
        center_local, radius_local = (_sphere_for_shape(inst.shape)
                                      if boundary else (np.zeros(3), 0.0))
        center = inst.sim.point(center_local)
        radius = inst.sim.scale * radius_local
        direction = inst.sim.vector([0.0, 1.0, 0.0])
        dn = np.linalg.norm(direction)
        if dn < 1e-8:
            continue
        delta = _spherecast_to_surface(surface, center, radius,
                                       direction / dn)
        if delta is None:
            continue
        out.append(inst.with_sim(inst.sim.translated(delta)))
    return _Out.instances(out)


def _r_rotation_to_gradient(node, outs, rng, sf):
    insts = _expect(outs[1], "instances", "meta_rotation_to_gradient")
    grad_sdf = _as_single_sdf(outs[0], "meta_rotation_to_gradient")
    if grad_sdf is None:
        return _Out.instances(list(insts))
    out = []
    for inst in insts:
        _, g = _sample_sdf_gradient(grad_sdf, inst.sim.trans)
        y = inst.sim.vector([0.0, 1.0, 0.0])
        yn, gn = np.linalg.norm(y), np.linalg.norm(g)
        if yn < 1e-8 or gn < 1e-8:
            continue
        q = _q_between(y / yn, g / gn)
        out.append(inst.with_sim(inst.sim.rotated(q)))
    return _Out.instances(out)


def _r_stochastic_selection(node, outs, rng, sf):
    child = outs[0]
    prob = float(np.clip(node.get("pick_probability", 1.0), 0.0, 1.0))
    lo = node.get("min_pick_count")
    hi = node.get("max_pick_count")

    def pick_count(n):
        if lo is None and hi is None:
            return n  # legacy: consider every item
        lo_i = int(lo or 0)
        hi_i = max(int(hi if hi is not None else n), lo_i)
        return min(int(rng.integers(lo_i, hi_i + 1)), n)

    if child.kind == "sdf":
        if child.value is None:
            return child
        keep = (lo is None or int(lo) > 0) and rng.uniform() < prob
        return _Out.sdf(child.value if keep else None)
    items = child.value
    count = pick_count(len(items))
    chosen = rng.choice(len(items), size=count, replace=False) if count else []
    kept = [items[i] for i in sorted(chosen) if rng.uniform() < prob]
    return _Out.group(kept) if child.kind == "group" else _Out.instances(kept)


def _r_sdf_instantiation(node, outs, rng, sf):
    insts = _expect(outs[0], "instances", "meta_sdf_instantiation")
    return _instantiate(insts, sf)


def _r_transform_application(node, outs, rng, sf):
    sdf_out, inst_out = outs
    if sdf_out.kind == "sdf":
        graphs = [] if sdf_out.value is None else [sdf_out.value]
    elif sdf_out.kind == "group":
        graphs = sdf_out.value
    else:
        raise ValueError("meta_transform_application expects SDF(s) as input 1")
    insts = _expect(inst_out, "instances", "meta_transform_application")
    out = []
    for g in graphs:
        for inst in insts:
            h = g
            sim = inst.sim
            if abs(sim.scale - 1.0) > 1e-9:
                h = atomic.scaling(h, sim.scale)
            if np.linalg.norm(sim.quat - _q_ident()) > 1e-9:
                h = atomic.rotation(h, tuple(float(x) for x in sim.quat))
            if np.any(np.abs(sim.trans) > 1e-12):
                h = atomic.translation(h, tuple(float(x) for x in sim.trans))
            out.append(h)
    return _Out.group(out)


def _r_noise(node, outs, rng, sf):
    child = outs[0]
    specs = {"octaves": node["octaves"], "frequency": node["frequency"],
             "lacunarity": node["lacunarity"],
             "persistence": node["persistence"], "amplitude": node["amplitude"]}
    once = node.get("sampling", "per_sdf") in ("once", "only_once")

    def wrap(p, g):
        return atomic.noise_modifier(
            g, octaves=max(int(round(p["octaves"])), 1),
            frequency=p["frequency"] / sf, lacunarity=p["lacunarity"],
            persistence=p["persistence"], amplitude=p["amplitude"] * sf,
            seed=int(rng.integers(0, 2 ** 31)))

    if child.kind == "sdf":
        if child.value is None:
            return child
        return _Out.sdf(wrap(sample_params(specs, rng), child.value))
    if child.kind == "group":
        params = sample_params(specs, rng)
        out = []
        for i, g in enumerate(child.value):
            out.append(wrap(params, g))
            if not once and i + 1 < len(child.value):
                params = sample_params(specs, rng)
        return _Out.group(out)
    raise ValueError("meta_noise expects SDF(s) input, got instances")


def _binary_sdf_resolver(op, drop_if_first_none, drop_if_second_none):
    def resolve(node, outs, rng, sf):
        a, b = outs
        for o in (a, b):
            if o.kind != "sdf":
                raise ValueError(f"{node['kind']} expects two SDF inputs, "
                                 f"got {o.kind}")
        sm = max(node["smoothness"] * sf, 0.0)
        if a.value is None:
            return _Out.sdf(None if drop_if_first_none else b.value)
        if b.value is None:
            return _Out.sdf(None if drop_if_second_none else a.value)
        return _Out.sdf(op(a.value, b.value, sm))
    return resolve


def _r_group_union(node, outs, rng, sf):
    sm = max(node["smoothness"] * sf, 0.0)
    graphs = []
    for o in outs:
        if o.kind == "instances":
            o = _instantiate(o.value, sf)
        if o.kind == "group":
            graphs.extend(o.value)
        elif o.value is not None:
            graphs.append(o.value)
    if not graphs:
        return _Out.sdf(None)
    return _Out.sdf(_balanced_union(graphs, sm))


_RESOLVERS = {
    "meta_points": _r_points,
    "meta_spheres": _primitive_resolver(_sphere_shape, _sphere_specs),
    "meta_capsules": _primitive_resolver(_capsule_shape, _capsule_specs),
    "meta_boxes": _primitive_resolver(_box_shape, _box_specs),
    "meta_translation": _r_translation,
    "meta_rotation": _r_rotation,
    "meta_scaling": _r_scaling,
    "meta_similarity": _r_similarity,
    "meta_stratified_grid": _r_stratified_grid,
    "meta_sphere_surface": _r_sphere_surface,
    "meta_closest_translation_to_surface": _r_closest_translation,
    "meta_ray_translation_to_surface": _r_ray_translation,
    "meta_rotation_to_gradient": _r_rotation_to_gradient,
    "meta_stochastic_selection": _r_stochastic_selection,
    "meta_sdf_instantiation": _r_sdf_instantiation,
    "meta_transform_application": _r_transform_application,
    "meta_noise": _r_noise,
    "meta_sdf_union": _binary_sdf_resolver(atomic.union, False, False),
    "meta_sdf_subtraction": _binary_sdf_resolver(atomic.subtraction, True, False),
    "meta_sdf_intersection": _binary_sdf_resolver(atomic.intersection, True, True),
    "meta_group_union": _r_group_union,
}


def _flatten_union(graph):
    if graph.get("kind") == "union":
        out = []
        for c in graph["children"]:
            out.extend(_flatten_union(c))
        return out
    return [graph]
