"""A config-4-shaped slice of the port against the JAX package, on the CPU:
the 17 x 61-bit chain at l = 16 (nd = 8), keygen, dealer encryption with
the fused r-stage, and threshold decryption.

BASELINE config 4 (``presets.threshold_256bit``) at a tiny size: n = 4
parties, k = 8, l = 16, bounds (50, 50). State is carried across with
``pvw_tpu_torch.convert``, so both packages compute from the same CRS,
secret keys and key words. The port's r-stage is forced through
``ntt_prescale_band`` (the routed function); the JAX package off the TPU
takes its XLA composition. Residues and shares: exact equality.
"""

import numpy as np
import jax
import pytest

import pvw_tpu as J
from pvw_tpu import errors as jerrors
from pvw_tpu.config import settings as jsettings
import pvw_tpu_torch as P
from pvw_tpu_torch import convert, errors as terrors
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.crypto import encryption as tenc
from pvw_tpu_torch.utils.intmath import generate_ntt_primes

N, K, ELL = 4, 8, 16
MODULI = generate_ntt_primes(61, 17, 16)


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


@pytest.fixture(scope="module")
def deep():
    jp = (J.PvwParametersBuilder().set_parties(N).set_dimension(K).set_l(ELL)
          .set_moduli(MODULI).set_secret_variance(0.5).set_error_bounds_u32(50, 50)
          .build())
    tp = convert.params_from_dict(jp.to_dict())
    assert tp.ring.num_digits == 8 and tp.ring.num_limbs == 17
    jkey = jax.random.key(4)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(jkey, 1))
    tcrs = convert.crs_from_residues(jcrs.matrix.residues_np(), tp, device="cpu")
    jparties = [J.Party.new(i, jp, jax.random.fold_in(jkey, 100 + i)) for i in range(N)]
    tsks = [convert.secret_key_from_coeffs(p.secret_key.secret_coeffs, tp)
            for p in jparties]
    jgpk = J.GlobalPublicKey(jcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(jkey, 2))
    tgpk = P.GlobalPublicKey(tcrs)
    tgpk.generate_all_keys(tsks, kw(jax.random.fold_in(jkey, 2)))
    shares = np.random.default_rng(40).integers(0, 1 << 32, size=(N, N), dtype=np.uint64)
    shares[0, :2] = [0, (1 << 32) - 1]
    cts = {}
    for stream in ("v3", "v3k"):
        key = jax.random.fold_in(jkey, 8)
        try:
            jsettings.noise_stream = stream
            tsettings.noise_stream = stream
            cts[stream] = (J.encrypt_all_party_shares_batched(shares, jgpk, key),
                           P.encrypt_all_party_shares_batched(shares, tgpk, kw(key)))
        finally:
            del jsettings.noise_stream, tsettings.noise_stream
    return jp, tp, jkey, jgpk, tgpk, jparties, tsks, shares, cts


def test_keygen_equals_jax(deep):
    _, _, _, jgpk, tgpk, _, _, _, _ = deep
    assert tgpk.is_full()
    np.testing.assert_array_equal(tgpk.matrix.residues_np(), jgpk.matrix.residues_np())


@pytest.mark.parametrize("stream", ["v3", "v3k"])
def test_dealer_ciphertexts_equal_jax(deep, stream):
    jct, tct = deep[-1][stream]
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())


@pytest.mark.parametrize("mode", ["1", "auto", "0"])
def test_r_stage_routing(deep, monkeypatch, mode):
    """Every ``fused_prescale`` mode takes the fused r-stage once (the port
    has one r-stage route) and gives the JAX package's ciphertext."""
    _, _, jkey, _, tgpk, _, _, shares, cts = deep
    calls = []
    real = tenc.ntt_prescale_band
    monkeypatch.setattr(tenc, "ntt_prescale_band",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    key = jax.random.fold_in(jkey, 8)
    try:
        tsettings.noise_stream = "v3"
        tsettings.fused_prescale = mode
        tct = P.encrypt_all_party_shares_batched(shares, tgpk, kw(key))
    finally:
        del tsettings.noise_stream, tsettings.fused_prescale
    assert len(calls) == 1
    np.testing.assert_array_equal(tct.c2.residues_np(), cts["v3"][1].c2.residues_np())


@pytest.mark.parametrize("form", ["batched", "list"])
def test_decrypt_valid_shares_equals_jax(deep, form):
    jp, _, jkey, jgpk, tgpk, jparties, tsks, shares, cts = deep
    jct, tct = cts["v3"]
    if form == "list":
        key = jax.random.fold_in(jkey, 8)
        try:
            jsettings.noise_stream = tsettings.noise_stream = "v3"
            jct = J.encrypt_all_party_shares(shares, jgpk, key)
            tct = P.encrypt_all_party_shares(shares, tgpk, kw(key))
        finally:
            del jsettings.noise_stream, tsettings.noise_stream
    valid = [3, 0, 2]
    try:
        jsettings.decode_mode = "python"
        for i in range(N):
            want = J.decrypt_valid_shares(jct, valid, 3, jparties[i].secret_key, i)
            got = P.decrypt_valid_shares(tct, valid, 3, tsks[i], i)
            assert got == want == [(dl, int(shares[dl, i])) for dl in valid]
    finally:
        del jsettings.decode_mode


@pytest.mark.parametrize("form", ["batched", "list"])
@pytest.mark.parametrize("valid,threshold", [([0, 1], 3), ([0, 0, 1], 2), ([0, 4, 1], 2),
                                             ([-1, 2], 1)])
def test_bad_subsets_raise_as_jax(deep, form, valid, threshold):
    _, _, _, _, _, jparties, tsks, _, cts = deep
    jct, tct = cts["v3"]
    if form == "list":
        jct = [jct] * N      # the checks come before any ciphertext is read
        tct = [tct] * N
    with pytest.raises(Exception) as jexc:
        J.decrypt_valid_shares(jct, valid, threshold, jparties[0].secret_key, 0)
    with pytest.raises(Exception) as texc:
        P.decrypt_valid_shares(tct, valid, threshold, tsks[0], 0)
    assert type(texc.value).__name__ == type(jexc.value).__name__
    assert type(texc.value).__name__ in ("InsufficientValidCiphertexts", "InvalidParameters")
    assert isinstance(jexc.value, jerrors.PvwError) and isinstance(texc.value, terrors.PvwError)
    if form == "list":
        with pytest.raises(type(texc.value)):
            P.select_valid_ciphertexts(tct, valid, threshold)


def test_party_index_checked(deep):
    _, _, _, _, _, _, tsks, _, cts = deep
    with pytest.raises(terrors.InvalidParameters, match="exceeds maximum"):
        P.decrypt_valid_shares(cts["v3"][1], [0, 1, 2], 2, tsks[0], N)
    assert P.select_valid_ciphertexts(["a", "b", "c"], [2, 0], 2) == [(2, "c"), (0, "a")]
