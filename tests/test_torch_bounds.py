"""Noise bounds beyond the signed-digit range in the port against the JAX
package, on the CPU.

Bounds above 32639 take residue noise (row-keyed, stream v2) added after
the fused matmul; bounds at or above the smallest modulus take exact host
sampling. Both samplers, keygen, encryption and decryption are held
against ``pvw_tpu``, and so is a ``secure_128_reference``-shaped slice (the
reference's own 128-bit parameters: 4 x 55-bit chain, l = 8, variance 10,
bounds (1, 1172385)) at tiny n and k under v3 and v3k. State is carried
across with ``pvw_tpu_torch.convert``. Residues and shares: exact equality.
"""

import numpy as np
import jax
import pytest
import torch

import pvw_tpu as J
from pvw_tpu.config import settings as jsettings
from pvw_tpu.params import presets as jpresets
from pvw_tpu.params.ring import RingPlan as JRing
from pvw_tpu.sampling import uniform as juni
import pvw_tpu_torch as P
from pvw_tpu_torch import convert
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.errors import InvalidParameters
from pvw_tpu_torch.params.ring import RingPlan as TRing
from pvw_tpu_torch.sampling import uniform as tuni

TOY = (0xFFFFC4001, 0x1FFFFE0001)


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


def residues(pair):
    return (np.asarray(pair[0]).astype(np.uint64) << np.uint64(32)) | np.asarray(pair[1])


@pytest.mark.parametrize("bound", [40000, 1172385, (1 << 31) + 5])
def test_residue_rows_sampler_equals_jax(bound):
    """96-bit draws below a range of 2^30, 128-bit draws above it."""
    jkey = jax.random.key(21)
    want = residues(juni.sample_uniform_residues_rows(jkey, 3, 4, (5, 8), bound,
                                                      JRing(TOY, 8)))
    got = tuni.sample_uniform_residues_rows(kw(jkey), 3, 4, (5, 8), bound, TRing(TOY, 8),
                                            device="cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


@pytest.mark.parametrize("bound", [1 << 40, (1 << 70) + 3])
def test_host_sampler_equals_jax(bound):
    """The host sampler seeds Python's generator with the key's bytes: the
    port's key must give the JAX key's, value for value."""
    jkey = jax.random.split(jax.random.key(22), 3)[2]
    want = residues(juni.sample_uniform_residues_host(jkey, (3, 2, 8), bound, JRing(TOY, 8)))
    got = tuni.sample_uniform_residues_host(kw(jkey), (3, 2, 8), bound, TRing(TOY, 8),
                                            device="cpu")
    assert got.shape == (3, 2, 2, 8)
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def build(moduli, l, variance, b1, b2, n, k, seed, exact_bounds=False):
    """The JAX package's system (CRS, parties, batch keys) and the port's
    keys made from the same CRS, secrets and key words."""
    builder = (J.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
               .set_moduli(moduli).set_secret_variance(variance))
    jp = (builder.set_error_bounds(b1, b2) if exact_bounds
          else builder.set_error_bounds_u32(b1, b2)).build()
    assert jp.verify_correctness_condition()
    tp = convert.params_from_dict(jp.to_dict())
    jkey = jax.random.key(seed)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(jkey, 1))
    jparties = [J.Party.new(i, jp, jax.random.fold_in(jkey, 10 + i)) for i in range(n)]
    jgpk = J.GlobalPublicKey(jcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(jkey, 2))
    tcrs = convert.crs_from_residues(jcrs.matrix.residues_np(), tp, device="cpu")
    tsks = [convert.secret_key_from_coeffs(p.secret_key.secret_coeffs, tp) for p in jparties]
    tgpk = P.GlobalPublicKey(tcrs)
    tgpk.generate_all_keys(tsks, kw(jax.random.fold_in(jkey, 2)))
    return jkey, jgpk, tgpk, jparties, tsks


def check_round_trip(jkey, jgpk, tgpk, jparties, tsks, stream):
    n = len(tsks)
    np.testing.assert_array_equal(tgpk.matrix.residues_np(), jgpk.matrix.residues_np())
    shares = np.random.default_rng(44).integers(0, 1 << 32, size=(n, n), dtype=np.uint64)
    key = jax.random.fold_in(jkey, 3)
    try:
        jsettings.noise_stream = tsettings.noise_stream = stream
        jsettings.decode_mode = "python"
        jct = J.encrypt_all_party_shares_batched(shares, jgpk, key)
        tct = P.encrypt_all_party_shares_batched(shares, tgpk, kw(key))
        np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
        np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
        for i in (0, n - 1):
            want = J.decrypt_party_shares(jct, jparties[i].secret_key, i)
            got = P.decrypt_party_shares(tct, tsks[i], i)
            assert got == want == [int(v) for v in shares[:, i]]
    finally:
        del jsettings.noise_stream, tsettings.noise_stream, jsettings.decode_mode


@pytest.mark.parametrize("stream", ["v3", "v3k"])
def test_residue_noise_path_equals_jax(stream):
    """Bounds (40000, 40000): keygen adds row-keyed residue e1 after the
    bare fused matmul; c1 and c2 (with the encode) likewise."""
    check_round_trip(*build(TOY, 8, 0.5, 40000, 40000, 4, 8, 23), stream)


@pytest.mark.parametrize("stream", ["v3", "v3k"])
def test_host_noise_path_equals_jax(stream):
    """Bounds 2^40 >= the smallest modulus: exact host noise in keygen and
    both products (``tests/test_v3k.py:279``'s system)."""
    jkey, jgpk, tgpk, jparties, tsks = build(TOY, 8, 0.5, 1 << 40, 1 << 40, 4, 8, 24,
                                             exact_bounds=True)
    check_round_trip(jkey, jgpk, tgpk, jparties, tsks, stream)
    with pytest.raises(InvalidParameters, match="device keygen unsupported"):
        P.GlobalPublicKey(tgpk.crs).generate_all_keys_device(
            torch.zeros((2, 8, 8), dtype=torch.int32), kw(jkey))


@pytest.mark.parametrize("stream", ["v3", "v3k"])
def test_secure_128_reference_slice_equals_jax(stream):
    """The reference's 128-bit parameters at n = 4, k = 8: c1 (bound 1)
    takes the noise planes or the v3k generator, c2 (bound 1172385) the
    encode-only product plus residue noise; keys, ciphertexts and shares
    equal the JAX package's."""
    ref = jpresets.secure_128_reference()
    assert (ref.error_bound_1, ref.error_bound_2, ref.l) == (1, 1172385, 8)
    check_round_trip(*build(jpresets.MODULI_55BIT4, 8, 10.0, 1, 1172385, 4, 8, 25), stream)
