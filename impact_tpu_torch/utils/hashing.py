"""Const FNV-1a string hashes, the port's copy of ``impact_tpu/utils/hashing.py``
(ref: interop/hashing/src/lib.rs:1-47): component ids and texture ids are
built from these, so ids agree between the two packages and across
processes."""

from __future__ import annotations

FNV32_OFFSET = 0x811C9DC5
FNV32_PRIME = 0x01000193
FNV64_OFFSET = 0xCBF29CE484222325
FNV64_PRIME = 0x00000100000001B3


def hash_str_to_u32(s: str) -> int:
    h = FNV32_OFFSET
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * FNV32_PRIME) & 0xFFFFFFFF
    return h


def hash_str_to_u64(s: str) -> int:
    h = FNV64_OFFSET
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * FNV64_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h
