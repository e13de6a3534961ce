"""Threefry keys with the semantics of ``jax.random`` (threefry2x32 impl,
``jax_threefry_partitionable=True``).

The scheme's outputs are defined by counter-based threefry streams (the
golden hashes, the row-keyed v2 and adaptive-width v3 streams, the v3k
global counters), so the port's generator is a threefry key rather than a
``torch.Generator``. A key is an int64 tensor ``[..., 2]`` of 32-bit words
(what ``jax.random.key_data`` returns); a leading batch of keys draws one
stream per key, as ``jax.vmap`` over keys does.

- ``key(seed)``: words (seed >> 32, seed & 0xFFFFFFFF);
- ``fold_in(key, d)``: threefry(key, (0, d));
- ``split(key, n)``: key i = threefry(key, (0, i)) (the partitionable,
  fold-like split);
- ``bits(key, shape)``: word f = y0 ^ y1 of threefry(key, (f >> 32,
  f & 0xFFFFFFFF)) for the flat index f.
"""

from __future__ import annotations

import math

import torch

from .ops.tfry import threefry2x32
from .ops.u64 import M32


def key(seed: int) -> torch.Tensor:
    """A key from an integer seed in [0, 2^64), on the CPU."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The key's 32-bit words, int64 [..., 2]."""
    return k


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """Key(s) derived from ``k`` and integer ``data`` (an int or an integer
    tensor, giving one key per element)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` keys [num, 2] derived from the single key ``k``."""
    return fold_in(k, torch.arange(num, dtype=torch.int64, device=k.device))


def bits(k: torch.Tensor, shape, device=None) -> torch.Tensor:
    """Uniform 32-bit words (int64 in [0, 2^32)) of ``shape``; a batched
    key [R, 2] gives [R, *shape], one stream per key."""
    shape = tuple(int(s) for s in shape)
    dev = k.device if device is None else torch.device(device)
    k = k.to(dev)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=dev)
    k0 = k[..., 0:1]
    k1 = k[..., 1:2]
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & M32)
    return (y0 ^ y1).reshape(tuple(k.shape[:-1]) + shape)
