"""``pvw_tpu_torch.sampling.normal`` and ``sample_uniform_coefficients``
against the JAX package's: the same seeded numpy Generator (or
``random.Random``) gives the same values, exactly. Both are host Python;
the reference's sigma/ratio quirk is pinned."""

import math
import random

import numpy as np
import pytest

from pvw_tpu.sampling import normal as jn, uniform as ju
import pvw_tpu_torch.sampling as TS
from pvw_tpu_torch.errors import SamplingError
from pvw_tpu_torch.sampling import normal as tn, uniform as tu

# 0, tiny (the ratio sampler's Gaussian branch), the quirk's uniform branch,
# the > 1e15 shortcut, past 2^127 and past a float's range
BOUNDS = [0, 1, 3, 5, 6, 100, 1172385, 10**16, 2**130, 2**1030]
VARIANCES = [0, 1, 10, 10**6, 2**70, 2**200, 2**236]


def both(fn_name, *args, seed=0):
    """``fn_name`` of each package on a fresh Generator of the same seed."""
    return (getattr(tn, fn_name)(*args, np.random.default_rng(seed)),
            getattr(jn, fn_name)(*args, np.random.default_rng(seed)))


def test_box_muller_equals_jax():
    got, want = both("box_muller")
    assert got == want and math.isfinite(got)
    rt, rj = np.random.default_rng(3), np.random.default_rng(3)
    assert [tn.box_muller(rt) for _ in range(50)] == [jn.box_muller(rj) for _ in range(50)]


@pytest.mark.parametrize("bound", BOUNDS)
def test_discrete_gaussian_and_bound_samplers_equal_jax(bound):
    got, want = both("sample_discrete_gaussian_vec", bound, 64, seed=bound % 97)
    assert got == want and all(-bound <= v <= bound for v in got)
    assert both("sample_single_gaussian", bound, seed=5)[0] == \
        both("sample_single_gaussian", bound, seed=5)[1]
    assert both("sample_bigint_normal_vec_u64", bound, 16)[0] == \
        both("sample_bigint_normal_vec_u64", bound, 16)[1]
    assert both("sample_bigint_normal_u64", bound)[0] == both("sample_bigint_normal_u64", bound)[1]


@pytest.mark.parametrize("variance", VARIANCES)
def test_variance_sampler_equals_jax(variance):
    got, want = both("sample_bigint_normal_vec", variance, 64, seed=7)
    assert got == want
    if variance == 0:
        assert got == [0] * 64


@pytest.mark.parametrize("bits", [0, 3, 20, 64, 200])
def test_bits_samplers_equal_jax(bits):
    assert both("sample_bigint_normal_vec_bits", bits, 32)[0] == \
        both("sample_bigint_normal_vec_bits", bits, 32)[1]
    assert both("sample_bigint_normal_bits", bits)[0] == both("sample_bigint_normal_bits", bits)[1]


def test_helpers_equal_jax():
    for ratio in (-1.0, -0.37, 0.0, 0.5, 1.0):
        for bound in (1, 1000, 2**100, 2**1000):
            assert tn._ratio_to_int(ratio, bound) == jn._ratio_to_int(ratio, bound)
    for sigma in (0.01, 0.2, 0.3, 0.31, 5.0):
        a = tn._sample_truncated_gaussian_ratio(np.random.default_rng(1), sigma)
        assert a == jn._sample_truncated_gaussian_ratio(np.random.default_rng(1), sigma)
    for variance in (2**80, 2**300, 5):
        a = tn._sample_large_variance_fallback(variance, np.random.default_rng(2))
        assert a == jn._sample_large_variance_fallback(variance, np.random.default_rng(2))
    assert tn.TAIL_STDDEV_MULTIPLIER == jn.TAIL_STDDEV_MULTIPLIER == 16.96


def test_sigma_ratio_quirk_is_pinned():
    """The absolute sigma (bound / 16.96) meets the ratio sampler's
    ``sigma > 0.3`` guard, so above bound ~5 the samples are round(u *
    bound) of a uniform u in [-1, 1]: uniform, not Gaussian."""
    bound = 100
    got = tn.sample_discrete_gaussian_vec(bound, 200, np.random.default_rng(11))
    rng = np.random.default_rng(11)
    assert got == [round(rng.uniform(-1.0, 1.0) * bound) for _ in range(200)]
    # a uniform spread: far more mass in the tails than a 16.96-sigma Gaussian
    assert sum(abs(v) > bound // 2 for v in got) > 60
    # at bound 5 (sigma 0.295) the Gaussian branch still runs
    rng = np.random.default_rng(11)
    assert tn._sample_truncated_gaussian_ratio(rng, 5 / 16.96) != \
        np.random.default_rng(11).uniform(-1.0, 1.0)


@pytest.mark.parametrize("bound", [0, 1, 50, 2**70])
def test_sample_uniform_coefficients_equals_jax(bound):
    got = tu.sample_uniform_coefficients(bound, 100, random.Random(bound))
    assert got == ju.sample_uniform_coefficients(bound, 100, random.Random(bound))
    assert all(-bound <= v <= bound for v in got)
    assert len(TS.sample_uniform_coefficients(bound, 5)) == 5        # SystemRandom
    with pytest.raises(SamplingError):
        tu.sample_uniform_coefficients(-1, 3)


def test_default_generators_are_fresh():
    assert len(tn.sample_discrete_gaussian_vec(10, 8)) == 8
    assert isinstance(tn.box_muller(), float)
    assert len(tn.sample_bigint_normal_vec(10, 4)) == 4
