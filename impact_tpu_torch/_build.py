"""Build and load the package's CUDA kernels.

One ``nvcc`` call compiles every ``csrc/*.cu`` into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds, not
minutes), written to ``_build/`` beside this file and keyed by a hash of the
sources and flags. It runs at first use; ``load()`` returns the library with
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
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# entry point -> argtypes (pointers and the stream are c_void_p)
SIGNATURES = {
    "k1_raster_depth": [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P],
    "k1_raster_attributes": [_P, _I, _P, _P, _P, _I, _I, _I, _I,
                             _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "k2_ccl_sweeps": [_P, _P, _P, _P, _I, _I, _I, _P],
}

_lib = None
build_seconds = None  # wall seconds of the nvcc run in this process, or 0.0 if cached


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


def build() -> Path:
    """Compile csrc/*.cu with one nvcc call unless the hashed library exists."""
    global build_seconds
    out = library_path()
    if out.exists():
        if build_seconds is None:
            build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    srcs = [str(s) for s in sorted(CSRC.glob("*.cu"))]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *srcs]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
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
