"""The port's fused r-stage (signed NTT + scaled-digit band) against the
JAX package, on the CPU.

``ntt_prescale_band`` on a CPU tensor runs its plain twin; it is held
against the JAX package's Pallas kernel ``ntt_prescale_band`` in interpret
mode and against its XLA composition
``prescale_digits_band(ntt_forward_signed_ch(...))``, on the same signed
coefficients. The band is int8 digits: exact equality. The CUDA kernel is
held against the twin in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pvw_tpu.ops import modmat as jmm
from pvw_tpu.ops import ntt as jntt
from pvw_tpu.ops import pallas_modmat as jpm
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.ring import get_ring as jring
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import get_ring as tring
from pvw_tpu_torch.utils.intmath import generate_ntt_primes

TOY = (0xFFFFC4001, 0x1FFFFE0001)
CHAIN_55X4 = (0x80000000080001, 0x80000000130001, 0x80000000190001, 0x800000001D0001)
CHAIN_61X17 = generate_ntt_primes(61, 17, 16)


def coeffs(seed, k, d, l, bound):
    rng = np.random.default_rng(seed)
    c = rng.integers(-bound, bound + 1, (k, d, l)).astype(np.int32)
    c[0, 0, :], c[0, 1, :] = bound, -bound            # both ends of the range
    return c


def port_band(c, moduli, l, bound):
    return tfm.ntt_prescale_band(torch.from_numpy(c), tring(moduli, l), bound).numpy()


@pytest.mark.parametrize("moduli,bound", [(TOY, 1), (TOY, 200), (CHAIN_55X4, 1)])
def test_band_equals_pallas_interpret(moduli, bound):
    """The three cases of tests/test_swapped.py (k = 16, d = 128)."""
    c = coeffs(5, 16, 128, 8, bound)
    want = jpm.ntt_prescale_band(jnp.asarray(c), jring(moduli, 8), bound, interpret=True)
    np.testing.assert_array_equal(port_band(c, moduli, 8, bound), np.asarray(want))


@pytest.mark.parametrize("bound", [1, 200])
def test_band_at_the_61bit_chain_equals_jax(bound):
    """17 x 61-bit limbs, l = 16 (config 4's chain): the XLA composition
    and the interpret-mode kernel."""
    c = coeffs(6, 8, 16, 16, bound)
    ring = jring(CHAIN_61X17, 16)
    got = port_band(c, CHAIN_61X17, 16, bound)
    assert got.shape == (17, 16, 8, 8 * 8, 16)
    xla = jmm.prescale_digits_band(jntt.ntt_forward_signed_ch(jnp.asarray(c), ring, bound),
                                   ring)
    np.testing.assert_array_equal(got, np.asarray(xla))
    if bound == 1:
        kern = jpm.ntt_prescale_band(jnp.asarray(c), ring, bound, interpret=True)
        np.testing.assert_array_equal(got, np.asarray(kern))


@pytest.mark.parametrize("moduli,l,C1", [(TOY, 8, 5), (TOY, 8, 6), (CHAIN_55X4, 8, 8),
                                         (CHAIN_61X17, 16, 8), (CHAIN_61X17, 16, 9)])
def test_prescale_tables_equal_jax(moduli, l, C1):
    t = tfm._prescale_tabs(tring(moduli, l), C1)
    j = jpm._prescale_tabs(jring(moduli, l), C1)[::l]     # per channel -> per limb
    G, nd = (C1 + 3) // 4, tring(moduli, l).num_digits
    join = lambda h, lo: ju.join_u64_np(j[:, h], j[:, lo])
    np.testing.assert_array_equal(t[:, 0], join(0, 1))
    np.testing.assert_array_equal(t[:, 1], join(2, 3))
    for g in range(G):
        np.testing.assert_array_equal(t[:, 2 + 2 * g], join(4 + 4 * g, 5 + 4 * g))
        np.testing.assert_array_equal(t[:, 3 + 2 * g], join(6 + 4 * g, 7 + 4 * g))
    o = 4 + 4 * G
    for i in range(1, nd):
        np.testing.assert_array_equal(t[:, 6 + 2 * i], join(o + 4 * (i - 1), o + 4 * (i - 1) + 1))
        np.testing.assert_array_equal(t[:, 7 + 2 * i],
                                      join(o + 4 * (i - 1) + 2, o + 4 * (i - 1) + 3))
    assert not t[:, 2 + 2 * G:8].any() and not t[:, 6 + 2 * nd:].any()


@pytest.mark.parametrize("l,jr", [(8, 1), (8, 2), (16, 1), (16, 2)])
def test_twiddle_table_is_the_banded_ntt_table(l, jr):
    moduli = TOY if l == 8 else CHAIN_61X17[:3]
    ring, jr_ = tring(moduli, l), jring(moduli, l)
    C1 = ring.num_digits + jr - 1
    got = tfm._prescale_ntab(ring, jr, "cpu").numpy()
    band = jr_.ntt_band_jr("fwd", jr)
    want = np.transpose(band.reshape(len(moduli), C1, l, l * jr), (0, 2, 1, 3))
    np.testing.assert_array_equal(got, want.reshape(len(moduli) * l, C1, l * jr))


@pytest.mark.parametrize("nd", [5, 8])
def test_digit_bias_identity(nd):
    """The kernel's digits: byte j of (x + 0x80..80) ^ 0x80..80, read as
    int8, is digit j of ``to_signed_digit_list`` (carry on >= 128, the final
    carry dropped) for every u64 pattern."""
    rng = np.random.default_rng(nd)
    x = np.concatenate([
        rng.integers(0, 1 << 63, 4000, dtype=np.uint64) * np.uint64(2)
        + rng.integers(0, 2, 4000, dtype=np.uint64),
        np.array([0, 127, 128, 255, 256, 0x7F7F, 0x8080, 0xFFFF, (1 << 63) - 1, 1 << 63,
                  (1 << 64) - 1, 0x8080808080808080, 0x7F7F7F7F7F7F7F7F], np.uint64)])
    want = torch.stack(tu.to_signed_digit_list(tu.u64_tensor(x), nd), -1).numpy()
    bias = np.uint64(0x8080808080808080)
    z = (x + bias) ^ bias                        # numpy uint64 wraps mod 2^64
    got = z.view(np.uint8).reshape(-1, 8)[:, :nd].view(np.int8)
    np.testing.assert_array_equal(got, want)


def test_available_and_wrapper_guards():
    ring = tring(TOY, 8)
    c = torch.from_numpy(coeffs(7, 2, 4, 8, 1))
    with pytest.raises(ValueError, match="residue path"):
        tfm.ntt_prescale_band(c, ring, 40000)
    with pytest.raises(ValueError, match="ring degree"):
        tfm.ntt_prescale_band(c[..., :4], ring, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.ntt_prescale_band(c.to("meta"), ring, 1)
    before = tfm.ntt_prescale_band.launches
    assert torch.equal(tfm.ntt_prescale_band(c, ring, 1),
                       tfm.ntt_prescale_band_plain(c, ring, 1))
    assert tfm.ntt_prescale_band.launches == before     # the CPU launches nothing
