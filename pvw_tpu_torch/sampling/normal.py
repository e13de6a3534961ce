"""Truncated discrete Gaussian sampling, the counterpart of
``pvw_tpu.sampling.normal`` (the reference's ``src/sampling/normal.rs``).

As in the reference, no key, encryption or decryption path uses this
module: the scheme's errors are bounded-uniform (``parameters.rs:263-284``).
It exists for API parity. Host Python with numpy's Generator, as in the JAX
package: the samplers return Python integers of any size, one at a time,
so there is nothing for a card to do; the same seeded Generator gives the
same values as the JAX package's.

QUIRK (kept, pinned by ``tests/test_torch_normal.py``): the reference
passes the ABSOLUTE sigma (bound/16.96) into the ratio-space rejection
sampler, whose ``sigma > 0.3`` guard (``normal.rs:151,169``) then takes
the uniform branch, so for any bound above ~5 the "truncated Gaussian" is
uniform on [-bound, bound]. Parity means keeping it.
"""

from __future__ import annotations

import math

import numpy as np

# sqrt(2 * ln(2^129)) — tail probability 2^-128 (``normal.rs:8``)
TAIL_STDDEV_MULTIPLIER = 16.96


def _rng(rng):
    return rng if rng is not None else np.random.default_rng()


def box_muller(rng=None) -> float:
    """Standard normal via Box-Muller (``normal.rs:186-190``)."""
    rng = _rng(rng)
    u1 = rng.uniform(np.finfo(float).eps, 1.0)
    u2 = rng.uniform(0.0, 1.0)
    return math.sqrt(-2.0 * math.log(u1)) * math.cos(2.0 * math.pi * u2)


def _sample_truncated_gaussian_ratio(rng, sigma: float) -> float:
    """Ratio in [-1, 1] from N(0, sigma^2) truncated (``normal.rs:165-183``)."""
    if sigma > 0.3:
        return rng.uniform(-1.0, 1.0)
    for _ in range(1000):
        r = box_muller(rng) * sigma
        if -1.0 <= r <= 1.0:
            return r
    return rng.uniform(-1.0, 1.0)


def _ratio_to_int(ratio: float, bound: int) -> int:
    """Ratio in [-1,1] -> integer in [-bound, bound] (``normal.rs:195-213``)."""
    bf = float(bound)
    if math.isfinite(bf):
        v = round(ratio * bf)
        if abs(v) < 1 << 127:
            return int(v)
    fp_bits = 53
    scaled = int(round(ratio * (1 << fp_bits)))
    return (scaled * bound) >> fp_bits


def sample_single_gaussian(bound: int, rng=None) -> int:
    """Single sample from N(0, (bound/16.96)^2) truncated to [-bound, bound]
    (``normal.rs:136-162``), including the reference's large-bound shortcut.
    """
    rng = _rng(rng)
    bound = int(bound)
    if bound == 0:
        return 0
    bound_f = float(bound) if bound < (1 << 1020) else math.inf
    if bound_f > 1e15:
        sign = 1 if rng.integers(0, 2) else -1
        return int(rng.integers(0, 1000001)) * sign
    sigma = bound_f / TAIL_STDDEV_MULTIPLIER
    ratio = _sample_truncated_gaussian_ratio(rng, sigma)
    x = _ratio_to_int(ratio, bound)
    return max(-bound, min(bound, x))


def sample_discrete_gaussian_vec(bound: int, n: int, rng=None) -> list[int]:
    """n samples, truncated discrete Gaussian (``normal.rs:12-20``)."""
    rng = _rng(rng)
    return [sample_single_gaussian(bound, rng) for _ in range(n)]


def _sample_from_variance(variance: int, rng) -> int:
    """Variance-parameterized sampling (``normal.rs:39-67``)."""
    variance = int(variance)
    if variance == 0:
        return 0
    try:
        var_f = float(variance)
    except OverflowError:
        var_f = math.inf
    if math.isfinite(var_f):
        sigma = math.sqrt(var_f)
        g = box_muller(rng) * sigma
        rounded = round(g)
        if abs(rounded) <= 2**63 - 1:
            return int(rounded)
    return _sample_large_variance_fallback(variance, rng)


def _sample_large_variance_fallback(variance: int, rng) -> int:
    """Bit-length-targeted fallback for huge variances (``normal.rs:70-107``)."""
    variance_bits = int(variance).bit_length()
    sigma_bits = variance_bits // 2
    if sigma_bits > 10:
        min_bits = max(sigma_bits // 4, 10)
        max_bits = min(sigma_bits + 20, 120)
        target_bits = int(rng.integers(min_bits, max_bits + 1))
    else:
        target_bits = int(rng.integers(1, 21))
    byte_count = target_bits // 8 + 1
    b = bytearray(rng.integers(0, 256, size=byte_count, dtype=np.uint8).tobytes())
    if byte_count > 0 and target_bits > 8:
        b[0] |= 0x80
    sample = int.from_bytes(bytes(b), "big")
    if rng.integers(0, 2):
        sample = -sample
    return sample


def sample_bigint_normal_vec(variance: int, n: int, rng=None) -> list[int]:
    """n variance-parameterized samples (``normal.rs:24-36``)."""
    rng = _rng(rng)
    return [_sample_from_variance(variance, rng) for _ in range(n)]


def sample_bigint_normal_vec_u64(variance: int, n: int, rng=None) -> list[int]:
    """``normal.rs:110-113`` (note: delegates to the BOUND-parameterized
    sampler, mirroring the reference's quirk)."""
    return sample_discrete_gaussian_vec(int(variance), n, rng)


def sample_bigint_normal_vec_bits(bits: int, n: int, rng=None) -> list[int]:
    """``normal.rs:116-119``."""
    return sample_discrete_gaussian_vec(2**int(bits), n, rng)


def sample_bigint_normal_u64(variance: int, rng=None) -> int:
    """``normal.rs:122-126``."""
    return sample_single_gaussian(int(variance), rng)


def sample_bigint_normal_bits(bits: int, rng=None) -> int:
    """``normal.rs:129-133``."""
    return sample_single_gaussian(2**int(bits), rng)
