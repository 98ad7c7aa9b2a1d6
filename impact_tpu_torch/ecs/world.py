"""Entity-component world as dense SoA arrays: the port's copy of
``impact_tpu/ecs/world.py`` (ref: impact_ecs/src/world.rs:20-101,
archetype.rs:170-236).

The whole world is one set of dense per-component SoA numpy arrays of
static capacity plus per-entity presence masks; an "archetype" is a mask
expression, and ``query`` returns the indices and column views of the
matching mask (the reference's ``query!``, impact_ecs/src/lib.rs:35-60).
Component ids are the FNV-1a u64 hashes of the component names, as in the
reference package, so a world means the same thing in both.

The world is host-side (numpy): it is the scripting and setup surface.
``runtime.setup.compile_scene`` lowers it into the simulation state on the
device. Mutations between steps go through the :class:`EntityStager` (ref:
impact_ecs/src/world.rs:54-101 deferred staging).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Iterable

import numpy as np

from ..utils.hashing import hash_str_to_u64

# --- component schema ---------------------------------------------------------

_COMPONENT_REGISTRY: dict[str, "ComponentMeta"] = {}


@dataclass(frozen=True)
class FieldSpec:
    name: str
    shape: tuple  # per-entity trailing shape, () for scalar
    dtype: Any


@dataclass(frozen=True)
class ComponentMeta:
    """Metadata for one component type (ref: impact_ecs/src/metadata.rs)."""

    name: str
    component_id: int
    fields: tuple[FieldSpec, ...]
    category: str  # "standard" | "setup" (ref: Component/SetupComponent derives)
    cls: type


def _field_spec_from_annotation(name: str, ann) -> FieldSpec:
    """Map python annotations to array specs: float, int, bool scalars;
    tuples like ("f32", 3) / ("f32", (3, 3)) for vectors/matrices."""
    if ann is float:
        return FieldSpec(name, (), np.float32)
    if ann is int:
        return FieldSpec(name, (), np.int32)
    if ann is bool:
        return FieldSpec(name, (), np.bool_)
    if isinstance(ann, tuple):
        kind, shape = ann
        dtype = {"f32": np.float32, "i32": np.int32, "u8": np.uint8,
                 "u32": np.uint32, "u64": np.uint64, "bool": np.bool_}[kind]
        if isinstance(shape, int):
            shape = (shape,)
        return FieldSpec(name, tuple(shape), dtype)
    raise TypeError(f"unsupported component field annotation {ann!r} for {name}")


def component(cls=None, *, setup: bool = False):
    """Class decorator registering a component type.

    The decorated class becomes a dataclass whose fields define the SoA
    columns. ``setup=True`` marks a setup component consumed and stripped by
    the entity-setup pipeline (ref: engine/src/setup.rs:18-69).
    """

    def wrap(c):
        c = dataclasses.dataclass(c)
        specs = tuple(
            _field_spec_from_annotation(f.name, f.type if not isinstance(f.type, str) else eval(f.type))  # noqa: S307
            for f in dataclasses.fields(c)
        )
        meta = ComponentMeta(
            name=c.__name__,
            component_id=hash_str_to_u64(c.__name__),
            fields=specs,
            category="setup" if setup else "standard",
            cls=c,
        )
        if c.__name__ in _COMPONENT_REGISTRY:
            raise ValueError(f"component {c.__name__} already registered")
        _COMPONENT_REGISTRY[c.__name__] = meta
        c.__component_meta__ = meta
        return c

    return wrap(cls) if cls is not None else wrap


def component_registry() -> dict[str, ComponentMeta]:
    return _COMPONENT_REGISTRY


# --- world --------------------------------------------------------------------

NO_ENTITY = np.uint64(0)


class World:
    """Host-side entity world: dense SoA columns + presence masks."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.alive = np.zeros(capacity, dtype=bool)
        self.entity_ids = np.zeros(capacity, dtype=np.uint64)
        self._id_to_index: dict[int, int] = {}
        self._next_counter_id = 1
        # component name → {"mask": bool[N], field: array[N, *shape]}
        self._columns: dict[str, dict[str, np.ndarray]] = {}
        self.stager = EntityStager(self)

    # --- storage ---------------------------------------------------------
    def _ensure_columns(self, meta: ComponentMeta):
        if meta.name in self._columns:
            return
        cols: dict[str, np.ndarray] = {
            "__mask__": np.zeros(self.capacity, dtype=bool)
        }
        for f in meta.fields:
            cols[f.name] = np.zeros((self.capacity, *f.shape), dtype=f.dtype)
        self._columns[meta.name] = cols

    # --- entity management -------------------------------------------------
    def create_entity(self, *components, entity_id: int | None = None) -> int:
        """Immediately create an entity with the given component instances.
        Returns the entity ID (u64). (ref: impact_ecs/src/world.rs:103-216)"""
        idx = int(np.argmin(self.alive))
        if self.alive[idx]:
            raise RuntimeError("world at capacity")
        if entity_id is None:
            entity_id = self._next_counter_id
            self._next_counter_id += 1
        if entity_id in self._id_to_index:
            raise ValueError(f"entity id {entity_id} already exists")
        self.alive[idx] = True
        self.entity_ids[idx] = np.uint64(entity_id)
        self._id_to_index[int(entity_id)] = idx
        for comp in components:
            self.add_component(entity_id, comp)
        return int(entity_id)

    def remove_entity(self, entity_id: int):
        idx = self._id_to_index.pop(int(entity_id))
        self.alive[idx] = False
        self.entity_ids[idx] = NO_ENTITY
        for cols in self._columns.values():
            cols["__mask__"][idx] = False

    def entity_index(self, entity_id: int) -> int:
        return self._id_to_index[int(entity_id)]

    def has_entity(self, entity_id: int) -> bool:
        return int(entity_id) in self._id_to_index

    @property
    def n_alive(self) -> int:
        return int(self.alive.sum())

    # --- component access ---------------------------------------------------
    def add_component(self, entity_id: int, comp):
        meta: ComponentMeta = comp.__component_meta__
        self._ensure_columns(meta)
        idx = self.entity_index(entity_id)
        cols = self._columns[meta.name]
        cols["__mask__"][idx] = True
        for f in meta.fields:
            cols[f.name][idx] = np.asarray(getattr(comp, f.name), dtype=f.dtype)

    def remove_component(self, entity_id: int, comp_cls):
        name = comp_cls.__name__
        idx = self.entity_index(entity_id)
        if name in self._columns:
            self._columns[name]["__mask__"][idx] = False

    def has_component(self, entity_id: int, comp_cls) -> bool:
        name = comp_cls.__name__
        if name not in self._columns:
            return False
        return bool(self._columns[name]["__mask__"][self.entity_index(entity_id)])

    def get_component(self, entity_id: int, comp_cls):
        """Materialize one entity's component as a dataclass instance."""
        meta: ComponentMeta = comp_cls.__component_meta__
        idx = self.entity_index(entity_id)
        cols = self._columns[meta.name]
        if not cols["__mask__"][idx]:
            raise KeyError(f"entity {entity_id} lacks {meta.name}")
        vals = {}
        for f in meta.fields:
            v = cols[f.name][idx]
            vals[f.name] = v.copy() if f.shape else v.item()
        return comp_cls(**vals)

    def set_field(self, entity_id: int, comp_cls, field_name: str, value):
        idx = self.entity_index(entity_id)
        self._columns[comp_cls.__name__][field_name][idx] = value

    def column(self, comp_cls, field_name: str) -> np.ndarray:
        """Raw SoA column [capacity, *shape] (shared memory, not a copy)."""
        return self._columns[comp_cls.__name__][field_name]

    def component_mask(self, comp_cls) -> np.ndarray:
        name = comp_cls.__name__
        if name not in self._columns:
            return np.zeros(self.capacity, dtype=bool)
        return self._columns[name]["__mask__"]

    # --- queries -------------------------------------------------------------
    def query_mask(self, *comp_classes, excluded: Iterable = ()) -> np.ndarray:
        """Boolean [capacity] mask of alive entities having all ``comp_classes``
        and none of ``excluded`` (the reference's archetype match,
        ref: impact_ecs_macros/src/query.rs [required]/[excluded] lists)."""
        mask = self.alive.copy()
        for c in comp_classes:
            mask &= self.component_mask(c)
        for c in excluded:
            mask &= ~self.component_mask(c)
        return mask

    def query(self, *comp_classes, excluded: Iterable = ()):
        """→ (indices, [per-component dict of column views]).

        Column views are the full-capacity arrays; index with the returned
        indices. Mutating them mutates the world (like ``&mut C`` queries).
        """
        mask = self.query_mask(*comp_classes, excluded=excluded)
        indices = np.nonzero(mask)[0]
        columns = []
        for c in comp_classes:
            cols = self._columns[c.__name__]
            columns.append({k: v for k, v in cols.items() if k != "__mask__"})
        return indices, columns

    def entities_with(self, *comp_classes, excluded: Iterable = ()) -> list[int]:
        mask = self.query_mask(*comp_classes, excluded=excluded)
        return [int(e) for e in self.entity_ids[mask]]

    def strip_setup_components(self, entity_id: int):
        """Remove all setup-category components (ref: engine/src/setup.rs:64-66)."""
        idx = self.entity_index(entity_id)
        for name, cols in self._columns.items():
            if _COMPONENT_REGISTRY[name].category == "setup":
                cols["__mask__"][idx] = False


# --- staging --------------------------------------------------------------------


class EntityStager:
    """Deferred entity create/remove/update, applied between frames
    (ref: impact_ecs/src/world.rs:54-101,896-1008 EntityStager)."""

    def __init__(self, world: World):
        self._world = world
        self._to_create: list[tuple[int | None, tuple]] = []
        self._to_remove: list[int] = []

    def stage_creation(self, *components, entity_id: int | None = None):
        self._to_create.append((entity_id, components))

    def stage_removal(self, entity_id: int):
        self._to_remove.append(int(entity_id))

    @property
    def pending(self) -> bool:
        return bool(self._to_create or self._to_remove)

    def apply(self) -> list[int]:
        """Apply staged ops; returns the IDs of newly created entities."""
        created = []
        for eid in self._to_remove:
            if self._world.has_entity(eid):
                self._world.remove_entity(eid)
        self._to_remove.clear()
        for eid, comps in self._to_create:
            created.append(self._world.create_entity(*comps, entity_id=eid))
        self._to_create.clear()
        return created
