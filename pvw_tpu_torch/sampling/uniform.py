"""Bounded-uniform sampling from threefry keys (stream v3).

The counterpart of ``pvw_tpu.sampling.uniform``: uniform integers in
[-bound, bound] as floor(X * range / 2^W) of W random bits, W = 96 for
range < 2^30 and W = 128 otherwise (distance from uniform < 2^-66).
Values are int64 tensors; ``_embed_centered`` turns them into residues.
Bounds at or above the smallest modulus take the exact host sampler
:func:`sample_uniform_residues_host`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..errors import SamplingError
from ..ops import u64 as u
from ..ops.tfry import reduce96
from ..params.ring import RingPlan
from ..random import bits, fold_in
from ..utils.device import resolve_device


def _bounded_from_words(words, range_size: int):
    """Draw words [..., 3] or [..., 4] -> values in [0, range_size)."""
    if range_size < 1 << 30:
        return reduce96(words[..., 0], words[..., 1], words[..., 2], range_size)
    # floor(X * R / 2^128), X = xh * 2^64 + xl: W = xh * R (128 bits);
    # the value is W's high word plus the carry of W's low word + hi(xl*R)
    r = u.as_i64(range_size)
    xh = (words[..., 0] << 32) | words[..., 1]
    xl = (words[..., 2] << 32) | words[..., 3]
    w_lo = xh * r
    s = w_lo + u.mulhi64(xl, r)
    return u.mulhi64(xh, r) + u.ult(s, w_lo).to(torch.int64)


def _words_needed(range_size: int) -> int:
    if not 1 <= range_size < 1 << 63:
        raise SamplingError(f"range {range_size} out of supported bounds")
    return 3 if range_size < 1 << 30 else 4


def sample_bounded_u64(key, shape, range_size: int, device="cuda") -> torch.Tensor:
    """Uniform integers in [0, range_size) as int64 [shape]."""
    nw = _words_needed(range_size)
    words = bits(key, tuple(shape) + (nw,), device=resolve_device(device))
    return _bounded_from_words(words, range_size)


def sample_uniform_signed_rows(key, row_offset: int, num_rows: int, shape_tail,
                               bound: int, device="cuda") -> torch.Tensor:
    """Row-keyed uniform values in [-bound, bound] as int32
    [num_rows, *shape_tail]: row i from ``fold_in(key, row_offset + i)``,
    the same stream as the JAX package's residue and signed samplers."""
    bound = int(bound)
    if not 0 < bound < 1 << 30:
        raise SamplingError(f"bound {bound} out of signed-path range")
    dev = resolve_device(device)
    keys = fold_in(key.to(dev), row_offset + torch.arange(num_rows, device=dev))
    words = bits(keys, tuple(shape_tail) + (3,))
    return (_bounded_from_words(words, 2 * bound + 1) - bound).to(torch.int32)


def _embed_centered(v, bound: int, ring: RingPlan):
    """Values in [0, 2*bound] (int64 [..., l]) -> centered residues
    (v - bound) mod q_i as int64 [..., L, l]."""
    q = ring.table("q", v.device)[:, None]                  # [L, 1]
    s = (v - int(bound))[..., None, :]                      # [..., 1, l]
    return torch.where(s < 0, s + q, s).expand(*v.shape[:-1], ring.num_limbs,
                                               v.shape[-1]).contiguous()


def sample_uniform_residues(key, shape, bound: int, ring: RingPlan,
                            device="cuda") -> torch.Tensor:
    """Uniform in [-bound, bound] as residues [..., L, l] (``shape`` ends
    with l). Requires bound < min(q_i)."""
    bound = int(bound)
    if bound <= 0:
        raise SamplingError("bound must be positive")
    if bound >= min(ring.moduli):
        raise SamplingError(
            f"bound {bound} >= smallest modulus; use host-side sampling"
        )
    v = sample_bounded_u64(key, shape, 2 * bound + 1, device)
    return _embed_centered(v, bound, ring)


def sample_uniform_coefficients(bound: int, count: int, rng=None) -> list[int]:
    """Uniform integers in [-bound, bound] as Python ints, the reference's
    public ``sample_uniform_coefficients`` (``uniform.rs:5-22``). ``rng``:
    an object with ``randint`` such as ``random.Random`` (default: a
    system-seeded ``random.SystemRandom``)."""
    import random as _random

    bound = int(bound)
    if bound < 0:
        raise SamplingError("bound must be non-negative")
    r = rng if rng is not None else _random.SystemRandom()
    return [r.randint(-bound, bound) for _ in range(count)]


def sample_uniform_residues_rows(key, row_offset: int, num_rows: int, shape_tail,
                                 bound: int, ring: RingPlan, device="cuda") -> torch.Tensor:
    """Row-keyed uniform values in [-bound, bound] ("stream v2") as
    residues [num_rows, *shape_tail[:-1], L, l]: row i from
    ``fold_in(key, row_offset + i)``, so any row block of a call holds the
    values the whole call would. Requires bound < min(q_i)."""
    bound = int(bound)
    if bound <= 0:
        raise SamplingError("bound must be positive")
    if bound >= min(ring.moduli):
        raise SamplingError(
            f"bound {bound} >= smallest modulus; use host-side sampling"
        )
    dev = resolve_device(device)
    range_size = 2 * bound + 1
    keys = fold_in(key.to(dev), row_offset + torch.arange(num_rows, device=dev))
    words = bits(keys, tuple(shape_tail) + (_words_needed(range_size),))
    return _embed_centered(_bounded_from_words(words, range_size), bound, ring)


def sample_uniform_residues_host(key, shape, bound: int, ring: RingPlan,
                                 device="cuda") -> torch.Tensor:
    """Exact host sampling of uniform values in [-bound, bound] of any
    magnitude (the reference's BigInt path, for bounds >= min(q_i)) as
    residues [..., L, l] (``shape`` ends with l). Python's
    ``random.Random`` seeded with the key's two 32-bit words as native
    uint32 bytes, the JAX package's ``key_data(key).tobytes()``, so the
    values match it."""
    import random as _random

    bound = int(bound)
    if bound <= 0:
        raise SamplingError("bound must be positive")
    data = np.asarray(key.detach().cpu().numpy(), np.uint32).ravel().tobytes()
    rng = _random.Random(data)
    count = math.prod(shape)
    vals = [rng.randint(-bound, bound) for _ in range(count)]
    res = np.array([[v % q for q in ring.moduli] for v in vals], np.uint64)
    res = np.moveaxis(res.reshape(tuple(shape) + (ring.num_limbs,)), -1, -2)
    return u.u64_tensor(res, resolve_device(device))
