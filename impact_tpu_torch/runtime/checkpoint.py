"""Simulation state checkpoint and resume: the port of
``impact_tpu/runtime/checkpoint.py``.

The whole ``SimState`` (bodies, voxel grids, meshes, solver cache, render
history, the fracture generator) goes into one compressed npz, keyed by
the reference's stringified field paths ("phys/bodies/position",
"voxels/sdf", "render/frame_index", ...), so a checkpoint that
``impact_tpu`` wrote loads here whole: the port's state has every field of
the reference's, the dense meshes' vertex materials
(``meshes/vert_type``, ``meshes/vert_type2``, ``meshes/vert_blend``) and
the chunk-submesh pool's top-2 type blend (``meshes/tri_type2``,
``meshes/tri_blend``) included. The one key that differs is
``rng_state``: the port's fracture ``torch.Generator`` state (uint8). The
reference stores its PRNG key under ``rng``; loading a file that has only
``rng`` seeds the generator from that key (``bridge._generator_from_key``),
so a run started under JAX resumes in the port, drawing other fracture
numbers than threefry would.

Integer index fields load into the port's widths (the reference keeps body
and slot indices in int32, the port in int64); every other field must have
the template's dtype, and every field its shape.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

RNG_STATE_KEY = "rng_state"
REFERENCE_RNG_KEY = "rng"


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: str, out: dict):
    if _is_namedtuple(tree):
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}{name}/", out)
        return
    key = prefix[:-1]
    if tree is None:
        return
    if isinstance(tree, torch.Generator):
        out[RNG_STATE_KEY] = tree.get_state().numpy()
    elif isinstance(tree, torch.Tensor):
        out[key] = tree.detach().cpu().numpy()
    elif isinstance(tree, int):
        out[key] = np.asarray(tree, np.int32)
    else:
        raise TypeError(f"{key}: cannot checkpoint a {type(tree).__name__}")


def save_checkpoint(path, sim, metadata: dict | None = None):
    """Write ``sim`` (a SimState, or any NamedTuple tree of tensors) to
    ``path`` (.npz)."""
    path = pathlib.Path(path)
    arrays: dict = {}
    _flatten(sim, "", arrays)
    meta = json.dumps(metadata or {})
    np.savez_compressed(path, __metadata__=np.frombuffer(meta.encode(), np.uint8), **arrays)
    return path


def _restore(tmpl, prefix: str, data, device):
    if _is_namedtuple(tmpl):
        return type(tmpl)(*(_restore(getattr(tmpl, name), f"{prefix}{name}/", data, device)
                            for name in tmpl._fields))
    key = prefix[:-1]
    if tmpl is None:
        return None
    if isinstance(tmpl, torch.Generator):
        if RNG_STATE_KEY in data:
            gen = torch.Generator(device=device)
            gen.set_state(torch.from_numpy(np.array(data[RNG_STATE_KEY])))
            return gen
        from ..bridge import _generator_from_key

        return _generator_from_key(data[REFERENCE_RNG_KEY], device)
    if key not in data:
        raise KeyError(f"checkpoint has no {key!r}")
    arr = np.array(data[key])
    if isinstance(tmpl, int):
        return int(arr)
    if tuple(arr.shape) != tuple(tmpl.shape):
        raise ValueError(f"{key}: checkpoint shape {arr.shape}, state {tuple(tmpl.shape)}")
    t = torch.from_numpy(arr)
    both_int = not (t.dtype.is_floating_point or tmpl.dtype.is_floating_point
                    or torch.bool in (t.dtype, tmpl.dtype))
    if t.dtype != tmpl.dtype and not both_int:
        raise ValueError(f"{key}: checkpoint dtype {t.dtype}, state {tmpl.dtype}")
    return t.to(device=device, dtype=tmpl.dtype)


def load_checkpoint(path, template, device="cuda"):
    """Restore a state saved by :func:`save_checkpoint` (or by the reference
    package's) into the structure and dtypes of ``template``, on ``device``.
    Returns (state, metadata)."""
    device = torch.device(device)
    with np.load(path) as data:
        meta = (json.loads(bytes(data["__metadata__"]).decode())
                if "__metadata__" in data else {})
        return _restore(template, "", data, device), meta
