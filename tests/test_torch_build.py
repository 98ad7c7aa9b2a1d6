"""Every C entry point of the port's CUDA sources is declared in
``_build.SIGNATURES`` with one argtype per parameter: an undeclared entry
point would get ctypes' default 32-bit int arguments and cut its pointers."""

import pathlib
import re

from impact_tpu_torch import _build

CSRC = pathlib.Path(_build.__file__).resolve().parent / "csrc"
ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)


def entry_points():
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in ENTRY.findall(src.read_text()):
            found[name] = [p.strip() for p in params.split(",") if p.strip()]
    return found


def test_every_entry_point_is_declared():
    found = entry_points()
    assert set(found) == set(_build.SIGNATURES)
    for name, params in found.items():
        argtypes = _build.SIGNATURES[name]
        assert len(argtypes) == len(params), name
        for param, argtype in zip(params, argtypes):
            is_pointer = "*" in param
            assert (argtype is _build._P) == is_pointer, (name, param)
