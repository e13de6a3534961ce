"""SipHash-1-3 with zero keys — Rust ``DefaultHasher`` semantics.

``PvwCrs::new_from_tag`` (``crs.rs:74-90``) derives its ChaCha seed by
hashing ``tag + "CRS"`` with ``std::collections::hash_map::DefaultHasher``,
which is SipHash-1-3 keyed with (0, 0), and Rust's ``Hash for str`` feeds
the UTF-8 bytes followed by a single 0xFF terminator byte.

The reference itself flags this as a TODO-grade weak derivation
(``crs.rs:73``); we reproduce it for tag compatibility and additionally
expose :func:`tag_seed` which documents the exact byte recipe.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def _rotl(x: int, b: int) -> int:
    return ((x << b) | (x >> (64 - b))) & _MASK


def _sipround(v0: int, v1: int, v2: int, v3: int):
    v0 = (v0 + v1) & _MASK
    v1 = _rotl(v1, 13)
    v1 ^= v0
    v0 = _rotl(v0, 32)
    v2 = (v2 + v3) & _MASK
    v3 = _rotl(v3, 16)
    v3 ^= v2
    v0 = (v0 + v3) & _MASK
    v3 = _rotl(v3, 21)
    v3 ^= v0
    v2 = (v2 + v1) & _MASK
    v1 = _rotl(v1, 17)
    v1 ^= v2
    v2 = _rotl(v2, 32)
    return v0, v1, v2, v3


def siphash13(data: bytes, k0: int = 0, k1: int = 0) -> int:
    """SipHash-1-3 of ``data`` -> u64 (c=1 compression, d=3 finalization)."""
    v0 = k0 ^ 0x736F6D6570736575
    v1 = k1 ^ 0x646F72616E646F6D
    v2 = k0 ^ 0x6C7967656E657261
    v3 = k1 ^ 0x7465646279746573
    n = len(data)
    full = n - (n % 8)
    for off in range(0, full, 8):
        m = int.from_bytes(data[off : off + 8], "little")
        v3 ^= m
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
        v0 ^= m
    b = (n & 0xFF) << 56
    b |= int.from_bytes(data[full:], "little")
    v3 ^= b
    v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    v0 ^= b
    v2 ^= 0xFF
    for _ in range(3):
        v0, v1, v2, v3 = _sipround(v0, v1, v2, v3)
    return (v0 ^ v1 ^ v2 ^ v3) & _MASK


def default_hasher_str(s: str) -> int:
    """``DefaultHasher::new()`` + ``s.hash(&mut h)`` + ``h.finish()``:
    SipHash-1-3(bytes || 0xFF) with zero keys."""
    return siphash13(s.encode("utf-8") + b"\xff")


def tag_seed(tag: str) -> bytes:
    """The reference's tag -> 32-byte seed expansion (``crs.rs:79-88``):
    hash ``tag + "CRS"``, then cycle the 8 little-endian hash bytes to fill
    32 bytes."""
    h = default_hasher_str(tag + "CRS")
    le = h.to_bytes(8, "little")
    return bytes(le[i % 8] for i in range(32))
