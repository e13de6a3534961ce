"""The port's host decryption and decode routing against the JAX package's.

``_host_decrypt`` runs the whole decryption (<s, c1> - c2, the inverse NTT,
the decode) in the C++ engine; on random residues it must equal the JAX
package's host path, its device stage with the Python decode, and the
port's plain contraction with its Python decode. ``_decode_mode`` must
route as the JAX router does over every mode, batch size, parameter set
and ``no_native``; threshold subsets below the crossover and single
messages decrypt on the host.
"""

import contextlib

import numpy as np
import jax
import pytest

import pvw_tpu as J
from pvw_tpu.config import settings as jsettings
from pvw_tpu.crypto import decryption as jdec
from pvw_tpu.ops import u64 as ju64
from pvw_tpu.utils.intmath import generate_ntt_primes
import pvw_tpu_torch as P
from pvw_tpu_torch import convert
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.crypto import decryption as tdec
from pvw_tpu_torch.ops import u64

CONFIGS = [
    (8, 32, 8, (0xFFFFC4001, 0x1FFFFE0001)),
    # the reference's 4 x 55-bit chain (examples/pvw_valid_dec.rs:40-45)
    (5, 64, 8, (0x80000000080001, 0x80000000130001, 0x80000000190001, 0x800000001d0001)),
    (4, 16, 16, (0xFFFFC4001, 0x1FFFFE0001, 0xFFFFEE001)),
]
TOY = CONFIGS[0]


def jax_params(n, k, l, moduli, variance=0.5, bounds=None):
    b1, b2 = bounds or J.PvwParameters.suggest_error_bounds(n, k, l, moduli, variance)
    return (J.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
            .set_moduli(moduli).set_secret_variance(variance)
            .set_error_bounds_u32(b1, b2).build())


def port(jp):
    return convert.params_from_dict(jp.to_dict())


def operands(jp, d, seed):
    rng = np.random.default_rng(seed)
    L, l, k = jp.ring.num_limbs, jp.l, jp.k
    qs = np.array(jp.ring.moduli, np.uint64).reshape(1, 1, L, 1)
    c1 = rng.integers(0, 1 << 63, (k, d, L, l), np.uint64) % qs
    c2 = rng.integers(0, 1 << 63, (d, L, l), np.uint64) % qs[0]
    return c1, c2


@contextlib.contextmanager
def both(**knobs):
    """The same knobs set in both packages' settings."""
    for name, value in knobs.items():
        setattr(tsettings, name, value)
        setattr(jsettings, name, value)
    try:
        yield
    finally:
        for name in knobs:
            delattr(tsettings, name)
            delattr(jsettings, name)


@pytest.mark.parametrize("n,k,l,moduli", CONFIGS)
def test_host_decrypt_matches_jax_and_python(n, k, l, moduli):
    jp = jax_params(n, k, l, moduli)
    tp = port(jp)
    assert tdec.native_decode.decrypt_decode_supported(tp)
    jsk = J.SecretKey.random(jp, jax.random.key(42))
    tsk = convert.secret_key_from_coeffs(jsk.secret_coeffs, tp)
    d = 5
    c1, c2 = operands(jp, d, seed=1)
    before = tdec.engine_calls.host
    got = tdec._host_decrypt(tp, tsk, u64.u64_tensor(c1), u64.u64_tensor(c2))
    assert tdec.engine_calls.host == before + 1
    np.testing.assert_array_equal(tsk.host_ntt_residues(), jsk.host_ntt_residues())
    c1h, c1l = ju64.split_u64_np(c1)
    c2h, c2l = ju64.split_u64_np(c2)
    jax_host = jdec._host_decrypt(jp, jsk, c1h, c1l, c2h, c2l)
    skp = jsk.to_polynomials()
    z = np.asarray(jdec._noisy_message_kernel(jp, skp.hi, skp.lo, c1h, c1l, c2h, c2l))
    residues = ju64.join_u64_np(z[0], z[1])
    jax_python = [jdec.decode_scalar_pvw_rns(residues[i], jp) for i in range(d)]
    zt = tdec._noisy_messages(tp, tsk.to_polynomials("cpu").res,
                              u64.u64_tensor(c1).permute(2, 3, 0, 1),
                              u64.u64_tensor(c2).permute(1, 2, 0))
    port_python = tdec._decode_batch(zt, tp, "python")
    assert got == jax_host == jax_python == port_python


def test_host_decrypt_noncontiguous_inputs():
    """Strided tensors and a strided key cache reach the engine in their
    logical order."""
    jp = jax_params(*TOY)
    tp = port(jp)
    tsk = convert.secret_key_from_coeffs(J.SecretKey.random(jp, jax.random.key(2)).secret_coeffs,
                                         tp)
    c1, c2 = operands(jp, 3, seed=9)
    want = tdec._host_decrypt(tp, tsk, u64.u64_tensor(c1), u64.u64_tensor(c2))
    c1t = u64.u64_tensor(c1.transpose(1, 3, 0, 2).copy()).permute(2, 0, 3, 1)
    c2t = u64.u64_tensor(c2.transpose(2, 1, 0).copy()).permute(2, 1, 0)
    assert not c1t.is_contiguous() and not c2t.is_contiguous()
    assert tdec._host_decrypt(tp, tsk, c1t, c2t) == want
    tsk._host_ntt_cache = np.asfortranarray(tsk.host_ntt_residues())
    u1, u2 = np.asfortranarray(c1), np.asfortranarray(c2)
    got = tdec.native_decode.decrypt_decode_pairs_native(
        tsk._host_ntt_cache, *ju64.split_u64_np(u1), *ju64.split_u64_np(u2), tp)
    assert got == want


# the three parameter sets of the router's grid: both engines; outside the
# C++ engine (17 x 61-bit at l = 8, Δ ~ 2^129); outside the device decode
# (a 36-bit q at l = 64, Δ = 1)
ROUTER_PARAMS = {
    "supported": lambda: jax_params(*TOY),
    "no_host_engine": lambda: jax_params(4, 8, 8, tuple(generate_ntt_primes(61, 17, 8))),
    "no_device_decode": lambda: jax_params(4, 8, 64, (0xFFFFC4001,), bounds=(1, 1)),
}


@pytest.mark.parametrize("which", list(ROUTER_PARAMS))
@pytest.mark.parametrize("mode", ["auto", "device", "host", "native", "python"])
def test_router_equals_jax(which, mode):
    """``_decode_mode`` over d in {None, 1, 63, 64, 65} with and without
    ``no_native`` returns what the JAX router returns."""
    jp = ROUTER_PARAMS[which]()
    tp = port(jp)
    seen = set()
    for no_native in (False, True):
        with both(decode_mode=mode, no_native=no_native):
            for d in (None, 1, 63, 64, 65):
                want = jdec._decode_mode(jp, d)
                assert tdec._decode_mode(tp, d) == want, (d, no_native)
                seen.add(want)
    if mode == "auto" and which == "supported":
        assert seen == {"host", "device"}
    if which == "no_device_decode" and mode in ("auto", "device"):
        assert "native" in seen


def test_crossover_knob():
    jp = jax_params(*TOY)
    tp = port(jp)
    with both(decode_crossover=5):
        assert [tdec._decode_mode(tp, d) for d in (4, 5)] == \
            [jdec._decode_mode(jp, d) for d in (4, 5)] == ["host", "device"]


@pytest.fixture(scope="module")
def system():
    """The toy system in both packages: keys from the JAX package, a batch
    of n dealers encrypted by each from the same key."""
    jp = jax_params(*TOY)
    tp = port(jp)
    key = jax.random.key(11)
    crs = J.PvwCrs.new(jp, jax.random.fold_in(key, 0))
    parties = [J.Party.new(i, jp, jax.random.fold_in(key, 100 + i)) for i in range(jp.n)]
    gpk = J.GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, jax.random.fold_in(key, 1))
    tgpk = convert.global_pk_from_residues(
        gpk.matrix.residues_np(), convert.crs_from_residues(crs.matrix.residues_np(), tp,
                                                            device="cpu"))
    tsks = [convert.secret_key_from_coeffs(p.secret_key.secret_coeffs, tp) for p in parties]
    vectors = np.array([[dd * 10 + r + 1 for r in range(jp.n)] for dd in range(jp.n)],
                       np.uint64)
    ekey = jax.random.fold_in(key, 6)
    tkey = convert.key_from_words(np.asarray(jax.random.key_data(ekey)))
    return (jp, parties, gpk, tsks, tgpk, vectors,
            J.encrypt_all_party_shares_batched(vectors, gpk, ekey),
            P.encrypt_all_party_shares_batched(vectors, tgpk, tkey), ekey, tkey)


@pytest.mark.parametrize("valid", [[1, 3, 5], [0, 2, 4, 6, 7]])
def test_threshold_subset_routes_to_host(system, valid):
    """A subset below the crossover decrypts on the host by default, equal
    to the device route and to the JAX package's host route."""
    jp, parties, _, tsks, _, vectors, jct, tct, _, _ = system
    tp = tsks[0].params
    assert tdec._decode_mode(tp, len(valid)) == "host" == jdec._decode_mode(jp, len(valid))
    before = dict(vars(tdec.engine_calls))
    got = P.decrypt_valid_shares(tct, valid, 2, tsks[0], 0)
    assert tdec.engine_calls.host == before["host"] + 1
    assert tdec.engine_calls.device == before["device"]
    with both(decode_mode="device"):
        on_device = P.decrypt_valid_shares(tct, valid, 2, tsks[0], 0)
    want = J.decrypt_valid_shares(jct, valid, 2, parties[0].secret_key, 0)
    assert got == on_device == want == [(i, int(vectors[i][0])) for i in valid]


def test_host_roundtrip_end_to_end(system):
    """Encrypt, then decrypt each party's value through the public API: the
    d = 1 route a latency-bound caller takes by default, equal to the JAX
    package's host route."""
    jp, parties, gpk, tsks, tgpk, _, _, _, ekey, tkey = system
    msgs = np.arange(1, jp.n + 1, dtype=np.uint64) * 7919
    tct, jct = P.encrypt(msgs, tgpk, tkey), J.encrypt(msgs, gpk, ekey)
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
    assert tdec._decode_mode(tsks[0].params, 1) == "host"
    before = tdec.engine_calls.host
    for i in range(jp.n):
        got = P.decrypt_party_value(tct, tsks[i], i)
        assert got == jdec.decrypt_party_value(jct, parties[i].secret_key, i) == int(msgs[i])
    assert tdec.engine_calls.host == before + jp.n
    # the full batch (d = n = 8) also takes the host route
    assert P.decrypt_party_shares(system[7], tsks[2], 2) == [int(v) for v in system[5][:, 2]]
