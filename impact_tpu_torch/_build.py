"""Build and load the package's CUDA kernels.

One ``nvcc`` per ``csrc/*.cu``, all started together, compiles the sources
to objects, and one more links them into a shared library with a plain C
interface (no PyTorch headers, so the build takes seconds, not minutes),
written to ``_build/`` beside this file and keyed by a hash of the sources
and flags. It runs at first use; ``load()`` returns the library with
every entry point's ``argtypes`` declared. There is no fallback: a missing
``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (pointers and the stream are c_void_p)
SIGNATURES = {
    "k1_raster_depth": [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "k1_raster_attributes": [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "k2_ccl_labels": [_P, _P, _I, _I, _P],
    "k2_ccl_sweeps": [_P, _P, _P, _P, _I, _I, _I, _P],
    "k2_ccl_wide": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "p1_probe_floor": [_I, _P, _P, _I, _P, _I, _P],
    "p2_probe_ablate": [_I, _I, _I, _I, _P, _P, _I, _P, _I, _I, _P, _P],
}

_lib = None
build_seconds = None  # wall seconds of the nvcc runs in this process, or 0.0 if cached


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libimpact_kernels_{h.hexdigest()[:16]}.so"


def _run(procs):
    """Wait for every (cmd, Popen); raise on the first that failed."""
    failed = None
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}"
    if failed:
        raise RuntimeError(failed)


def build() -> Path:
    """Compile csrc/*.cu (one nvcc per source, in parallel) and link them,
    unless the hashed library exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        if build_seconds is None:
            build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        objs.append(obj)
    try:
        _run(procs)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                     text=True))])
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    os.replace(tmp, out)
    return out


def load():
    """The kernel library, built on first use, with argtypes declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
