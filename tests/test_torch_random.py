"""Parity of the port's threefry keys and samplers with ``jax.random`` and
the JAX package's streams (v2 row keys, v3 adaptive width, v3k global
counters, cbd-k). Integer draws: exact equality."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pvw_tpu.ops import ntt as jntt
from pvw_tpu.ops import pallas_modmat as jpm
from pvw_tpu.ops import tfry as jtfry
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.ring import RingPlan as JRing
from pvw_tpu.sampling import cbd as jcbd
from pvw_tpu.sampling import uniform as juni
from pvw_tpu_torch import random as R
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import ntt as tntt
from pvw_tpu_torch.ops import tfry as ttfry
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import RingPlan as TRing
from pvw_tpu_torch.sampling import cbd as tcbd
from pvw_tpu_torch.sampling import uniform as tuni

TOY = (0xFFFFC4001, 0x1FFFFE0001)


def words(jkey):
    return np.asarray(jax.random.key_data(jkey)).astype(np.int64)


def u32(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 1234, (1 << 31) - 1])
def test_key_ops_and_bits_equal_jax(seed):
    jk, tk = jax.random.key(seed), R.key(seed)
    np.testing.assert_array_equal(R.key_data(tk).numpy(), words(jk))
    jf, tf = jax.random.fold_in(jk, 99), R.fold_in(tk, 99)
    np.testing.assert_array_equal(tf.numpy(), words(jf))
    np.testing.assert_array_equal(R.split(tk, 3).numpy(), words(jax.random.split(jk, 3)))
    np.testing.assert_array_equal(
        R.bits(tf, (5, 7, 3)).numpy(), u32(jax.random.bits(jf, (5, 7, 3), jnp.uint32)))
    keys = jax.vmap(lambda i: jax.random.fold_in(jk, i))(jnp.arange(2, 6))
    rows = jax.vmap(lambda k: jax.random.bits(k, (3, 4), jnp.uint32))(keys)
    np.testing.assert_array_equal(
        R.bits(R.fold_in(tk, torch.arange(2, 6)), (3, 4)).numpy(), u32(rows))


@pytest.mark.parametrize("variance", [0.5, 2.0, 16.0])
def test_cbd_equal_jax(variance):
    jk = jax.random.fold_in(jax.random.key(5), 3)
    tk = R.fold_in(R.key(5), 3)
    np.testing.assert_array_equal(
        tcbd.sample_vec_cbd(tk, (6, 8), variance, device="cpu").numpy(),
        np.asarray(jcbd.sample_vec_cbd(jk, (6, 8), variance)))
    np.testing.assert_array_equal(
        tcbd.sample_vec_cbd_rows(tk, 3, 4, (5, 8), variance, device="cpu").numpy(),
        np.asarray(jcbd.sample_vec_cbd_rows(jk, 3, 4, (5, 8), variance)))


@pytest.mark.parametrize("range_size", [1, 101, (1 << 30) - 1, 1 << 30,
                                        0xFFFFC4001, (1 << 62) + 12345])
def test_sample_bounded_u64_equal_jax(range_size):
    jk, tk = jax.random.key(11), R.key(11)
    got = tu.u64_numpy(tuni.sample_bounded_u64(tk, (7, 9), range_size, device="cpu"))
    want = ju.join_u64_np(*map(np.asarray, juni.sample_bounded_u64(jk, (7, 9), range_size)))
    np.testing.assert_array_equal(got, want)
    assert got.max() < range_size


def test_signed_rows_and_residues_equal_jax():
    jk, tk = jax.random.key(12), R.key(12)
    np.testing.assert_array_equal(
        tuni.sample_uniform_signed_rows(tk, 2, 3, (4, 8), 50, device="cpu").numpy(),
        np.asarray(juni.sample_uniform_signed_rows(jk, 2, 3, (4, 8), 50)))
    tr, jr = TRing(TOY, 8), JRing(TOY, 8)
    got = tuni.sample_uniform_residues(tk, (3, 8), 70, tr, device="cpu")
    want = juni.sample_uniform_residues(jk, (3, 8), 70, jr)
    np.testing.assert_array_equal(tu.u64_numpy(got), ju.join_u64_np(*map(np.asarray, want)))


@pytest.mark.parametrize("bound", [50, 2000])
def test_noise_digit_planes_equal_jax(bound):
    jk, tk = jax.random.key(13), R.key(13)
    got = tntt.noise_digit_planes(tk, 4, 5, 6, 8, bound, device="cpu")
    want = jntt.noise_digit_planes(jk, 4, 5, 6, 8, bound)
    assert got.shape == (8 * jntt.signed_digit_count(bound), 5, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bound", [50, 2000])
def test_v3k_values_and_planes_equal_jax(bound):
    k0, k1 = 0x12345678, 0x9ABCDEF0
    got = ttfry.v3k_values(k0, k1, 3, 4, 5, 8, bound, col_off=7)
    want = jtfry.v3k_values(jnp.uint32(k0), jnp.uint32(k1), 3, 4, 5, 8, bound, col_off=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = ttfry.v3k_noise_digit_planes(k0, k1, 0, 4, 5, 8, bound, col_off=2)
    want = jtfry.v3k_noise_digit_planes(jnp.uint32(k0), jnp.uint32(k1), 0, 4, 5, 8,
                                        bound, col_off=2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variance", [0.5, 3.0, 9.0])
def test_v3k_cbd_values_equal_jax(variance):
    k0, k1 = 77, 0xFFFFFFFF
    got = ttfry.v3k_cbd_values(k0, k1, 1, 3, 6, 8, variance, col_off=5)
    want = jtfry.v3k_cbd_values(jnp.uint32(k0), jnp.uint32(k1), 1, 3, 6, 8, variance,
                                col_off=5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_threefry_and_v4_helpers_equal_jax():
    rng = np.random.default_rng(14)
    x0, x1 = (rng.integers(0, 1 << 32, size=64, dtype=np.uint64) for _ in range(2))
    got = ttfry.threefry2x32(5, 0xDEADBEEF, torch.from_numpy(x0.astype(np.int64)),
                             torch.from_numpy(x1.astype(np.int64)))
    want = jtfry.threefry2x32(np.uint32(5), np.uint32(0xDEADBEEF),
                              jnp.asarray(x0.astype(np.uint32)), jnp.asarray(x1.astype(np.uint32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), u32(w))
    b = [rng.integers(0, 1 << 32, size=64, dtype=np.uint64) for _ in range(3)]
    got = tfm.v4_reduce96(*(torch.from_numpy(v.astype(np.int64)) for v in b), 101)
    want = jpm.v4_reduce96(*(jnp.asarray(v.astype(np.uint32)) for v in b), np.uint32(101))
    np.testing.assert_array_equal(got.numpy(), u32(want))
    sv = torch.arange(-32639, 32640, 97, dtype=torch.int32)
    for g, w in zip(tfm.v4_digit_split(sv), jpm.v4_digit_split(jnp.asarray(sv.numpy()))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    r0 = torch.tensor([0, 8, 4096, 1 << 13])
    c0 = torch.tensor([0, 128, 256, 1 << 23])
    np.testing.assert_array_equal(tfm.v4_blockmix(r0, c0).numpy(),
                                  np.asarray(jpm.v4_blockmix(jnp.asarray(r0.numpy()),
                                                             jnp.asarray(c0.numpy()))))
