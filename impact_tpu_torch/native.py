"""ctypes bindings of the host tessellation library (port of
``impact_tpu/native.py``; ref: impact_tesselation delaunay.rs and
voronoi.rs).

``cpp/tessellation.cpp`` implements incremental 3D Delaunay
(Bowyer-Watson) and Voronoi cell extraction. It is built at first use with
the host C++ compiler (``$CXX``, else ``g++``) into ``_build/`` beside this
file, keyed by a hash of the source and flags, and loaded with ctypes.
There is no fallback: a missing compiler or a failed build raises. It is a
CPU library; nothing on the device path calls it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "cpp" / "tessellation.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_lib = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libimpact_tessellation_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless this source's build is already there.
    Writes to a temporary name and renames it, so that concurrent builds
    never load a half-written file."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler found (set CXX): the tessellation library needs one")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the tessellation build failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    fp, ip = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int)
    lib.impact_delaunay_tetrahedralize.restype = ctypes.c_int
    lib.impact_delaunay_tetrahedralize.argtypes = [fp, ctypes.c_int, ip, ctypes.c_int]
    lib.impact_voronoi_cell_vertices.restype = ctypes.c_int
    lib.impact_voronoi_cell_vertices.argtypes = [fp, ctypes.c_int, ip, ctypes.c_int,
                                                 ctypes.c_int, fp, ctypes.c_int]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the native library builds (or is built) and loads."""
    try:
        _load()
        return True
    except Exception:
        return False


def delaunay_tetrahedralize(points) -> np.ndarray:
    """3D Delaunay tetrahedralization: points [N,3] → [T,4] int32
    tetrahedron vertex indices."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    max_tets = max(64, 8 * n)
    out = np.empty((max_tets, 4), np.int32)
    count = lib.impact_delaunay_tetrahedralize(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), max_tets)
    if count < 0:
        raise RuntimeError("delaunay: tetrahedron buffer overflow")
    return out[:count].copy()


def voronoi_cell_vertices(points, tets, site: int) -> np.ndarray:
    """The Voronoi cell vertices of ``site``: the circumcentres of its
    incident tetrahedra, [K,3] float32."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    tt = np.ascontiguousarray(tets, np.int32)
    max_v = max(64, len(tt))
    out = np.empty((max_v, 3), np.float32)
    count = lib.impact_voronoi_cell_vertices(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pts),
        tt.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(tt), int(site),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), max_v)
    if count < 0:
        raise RuntimeError("voronoi: vertex buffer overflow")
    return out[:count].copy()
