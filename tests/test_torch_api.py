"""The CRS, SecretKey, PvwCiphertext, PvwParameters and Poly API of the
port against the JAX package on the same seeds, on the CPU."""

import numpy as np
import jax
import pytest
import torch

import pvw_tpu as J
from pvw_tpu import poly as jpoly
import pvw_tpu_torch as P
from pvw_tpu_torch import convert, poly as tpoly
from pvw_tpu_torch.errors import (DimensionMismatch, EncodingError, IndexOutOfBounds,
                                  InvalidParameters, PolynomialError)

MODULI = (0xFFFFC4001, 0x1FFFFE0001)
NTT, POWER = P.Representation.Ntt, P.Representation.PowerBasis


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


def residues_equal(t, j):
    np.testing.assert_array_equal(t.residues_np(), j.residues_np())


@pytest.fixture(scope="module")
def system():
    jp = (J.PvwParametersBuilder().set_parties(4).set_dimension(6).set_l(8)
          .set_moduli(MODULI).set_secret_variance(2.0).set_error_bounds_u32(90, 300).build())
    tp = convert.params_from_dict(jp.to_dict())
    key = jax.random.key(5)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(key, 0))
    tcrs = convert.crs_from_residues(jcrs.matrix.residues_np(), tp, device="cpu")
    jsk = J.SecretKey.random(jp, jax.random.fold_in(key, 1))
    tsk = convert.secret_key_from_coeffs(jsk.secret_coeffs, tp)
    return jp, tp, key, jcrs, tcrs, jsk, tsk


# --------------------------------------------------------------------------
# PvwCrs
# --------------------------------------------------------------------------

def test_crs_products_equal_jax(system):
    jp, tp, key, jcrs, tcrs, jsk, tsk = system
    residues_equal(tcrs.multiply_by_secret_key(tsk), jcrs.multiply_by_secret_key(jsk))
    for batch in ((jp.k,), (jp.k, 3)):
        jr = J.Poly.random(jp.ring, NTT, jax.random.fold_in(key, len(batch)), batch)
        tr = P.Poly.from_residues_np(jr.residues_np(), tp.ring, NTT, device="cpu")
        residues_equal(tcrs.multiply_by_randomness(tr), jcrs.multiply_by_randomness(jr))
    with pytest.raises(DimensionMismatch):
        tcrs.multiply_by_randomness(P.Poly.zero(tp.ring, NTT, (jp.k - 1,), device="cpu"))
    small = P.PvwCrs(tcrs.matrix[:2, :2], tp)
    with pytest.raises(IndexOutOfBounds):
        small.multiply_by_secret_key(tsk)


def test_crs_set_element_iteration(system):
    jp, tp, key, jcrs, tcrs, jsk, tsk = system
    tcrs2 = P.PvwCrs(tcrs.matrix, tp)
    jcrs2 = J.PvwCrs(jcrs.matrix, jp)
    jq = J.Poly.random(jp.ring, POWER, jax.random.fold_in(key, 7), ())
    tq = P.Poly.from_residues_np(jq.residues_np(), tp.ring, POWER, device="cpu")
    old = tcrs2.matrix.res
    tcrs2.set_element(1, 4, tq)
    jcrs2.set_element(1, 4, jq)
    assert tcrs2.matrix.res is not old                  # a new tensor, the old one kept
    np.testing.assert_array_equal(old.numpy(), tcrs.matrix.res.numpy())
    residues_equal(tcrs2.matrix, jcrs2.matrix)
    residues_equal(tcrs2.get(1, 4), jq.to_ntt())
    with pytest.raises(InvalidParameters, match="out of bounds"):
        tcrs2.set_element(jp.k, 0, tq)
    elems = list(tcrs2)
    assert len(elems) == len(tcrs2) == jp.k * jp.k and not tcrs2.is_empty()
    for t, j in zip(elems[::7], list(jcrs2)[::7]):
        residues_equal(t, j)


# --------------------------------------------------------------------------
# SecretKey
# --------------------------------------------------------------------------

def test_secret_key_accessors(system):
    jp, tp, key, jcrs, tcrs, jsk, tsk = system
    sk = P.SecretKey(tp, jsk.secret_coeffs)
    np.testing.assert_array_equal(sk.host_ntt_residues(), jsk.host_ntt_residues())
    residues_equal(sk.get_polynomial(2, device="cpu"), jsk.get_polynomial(2))
    residues_equal(sk.as_poly_vector(device="cpu"), jsk.as_poly_vector())
    with pytest.raises(InvalidParameters, match="out of bounds"):
        sk.get_polynomial(jp.k, device="cpu")
    assert sk.coefficient_stats() == jsk.coefficient_stats()
    np.testing.assert_array_equal(sk.to_coefficient_matrix(), jsk.to_coefficient_matrix())
    np.testing.assert_array_equal(sk.as_matrix(), jsk.as_matrix())
    assert sk.as_matrix_mut() is not sk.secret_coeffs
    np.testing.assert_array_equal(sk.get_coefficients(1), jsk.get_coefficients(1))
    assert sk.get_coefficients(jp.k) is None and sk.get_coefficients_mut(-1) is None
    assert not sk.is_empty()
    # a mutable accessor drops both caches: the next NTT sees the change
    sk.get_coefficients_mut(0)[0] += 1
    jsk2 = J.SecretKey(jp, sk.secret_coeffs)
    np.testing.assert_array_equal(sk.host_ntt_residues(), jsk2.host_ntt_residues())
    residues_equal(sk.to_polynomials("cpu"), jsk2.to_polynomials())
    sk.coefficients_mut()[1, 1] -= 3
    jsk3 = J.SecretKey(jp, sk.secret_coeffs)
    residues_equal(sk.to_polynomials("cpu"), jsk3.to_polynomials())
    np.testing.assert_array_equal(sk.host_ntt_residues(), jsk3.host_ntt_residues())
    sk.zeroize()
    assert sk.is_empty() and sk.coefficient_stats() == (0, 0, 0.0)


def test_secret_key_coefficient_bounds_quirk(system):
    """``2 * (variance as i64)``: variance 2.0 bounds at 4; 0.5 at 0."""
    jp, tp, key, jcrs, tcrs, jsk, tsk = system
    coeffs = np.zeros((jp.k, jp.l), np.int32)
    coeffs[2, 3] = 4
    P.SecretKey(tp, coeffs).validate_coefficient_bounds()
    coeffs[2, 3] = -5
    with pytest.raises(InvalidParameters, match="polynomial 2 index 3 is -5") as e:
        P.SecretKey(tp, coeffs).validate_coefficient_bounds()
    with pytest.raises(J.errors.InvalidParameters) as je:
        J.SecretKey(jp, coeffs).validate_coefficient_bounds()
    assert str(e.value) == str(je.value)
    half = convert.params_from_dict(dict(jp.to_dict(), secret_variance=0.5))
    coeffs[2, 3] = 1
    with pytest.raises(InvalidParameters, match=r"\[-0, 0\]"):
        P.SecretKey(half, coeffs).validate_coefficient_bounds()


# --------------------------------------------------------------------------
# PvwCiphertext
# --------------------------------------------------------------------------

def test_ciphertext_accessors(system):
    jp, tp, key, jcrs, tcrs, jsk, tsk = system
    gpk = P.GlobalPublicKey(tcrs)
    gpk.generate_all_keys([tsk] * jp.n, kw(key))
    ct = P.encrypt(np.arange(jp.n, dtype=np.uint64), gpk, kw(key))
    assert ct.c1_components() is ct.c1 and ct.c2_components() is ct.c2
    assert not ct.is_empty() and len(ct) == jp.n
    empty = P.PvwCiphertext(P.Poly.zero(tp.ring, NTT, (0,), device="cpu"),
                            P.Poly.zero(tp.ring, NTT, (0,), device="cpu"), tp)
    assert empty.is_empty()


# --------------------------------------------------------------------------
# PvwParameters and the builder
# --------------------------------------------------------------------------

def test_parameter_sampling_equals_jax(system):
    jp, tp, key, *_ = system
    k1 = jax.random.fold_in(key, 31)
    residues_equal(tp.sample_secret_polynomial(kw(k1), device="cpu"),
                   jp.sample_secret_polynomial(k1))
    for batch in ((), (3,), (2, 3)):
        residues_equal(tp.sample_error_1(kw(k1), batch, device="cpu"), jp.sample_error_1(k1, batch))
        residues_equal(tp.sample_error_2(kw(k1), batch, device="cpu"), jp.sample_error_2(k1, batch))
    # bounds at and above the smallest modulus take the exact host draw
    huge = dict(jp.to_dict(), error_bound_1=str(1 << 40), error_bound_2=str(min(MODULI)))
    jh, th = J.PvwParameters.from_dict(huge), convert.params_from_dict(huge)
    residues_equal(th.sample_error_1(kw(k1), (2,), device="cpu"), jh.sample_error_1(k1, (2,)))
    residues_equal(th.sample_error_2(kw(k1), (2,), device="cpu"), jh.sample_error_2(k1, (2,)))


@pytest.mark.parametrize("scalar", [0, 1, 12345, (1 << 63) - 1, 1 << 63, (1 << 64) - 1])
def test_encodings_equal_jax(system, scalar):
    jp, tp, *_ = system
    residues_equal(tp.encode_scalar(scalar, device="cpu"), jp.encode_scalar(scalar))
    residues_equal(tp.scalar_to_polynomial(scalar, device="cpu"), jp.scalar_to_polynomial(scalar))


def test_gadget_and_bigints_equal_jax(system):
    jp, tp, *_ = system
    assert tp.gadget_element() == jp.gadget_element() == list(reversed(tp.gadget_vector()))
    residues_equal(tp.gadget_polynomial(device="cpu"), jp.gadget_polynomial())
    ints = [-(1 << 80), -1, 0, 1, tp.q_total() + 5, 3 ** 50, -(3 ** 40), 7]
    residues_equal(tp.bigints_to_poly(ints, device="cpu"), jp.bigints_to_poly(ints))
    assert tp.bigints_to_poly(ints, device="cpu").rep == POWER
    with pytest.raises(EncodingError):
        tp.encode_scalar(1 << 64, device="cpu")
    with pytest.raises(EncodingError):
        tp.encode_scalar(-1, device="cpu")
    assert tp.rns_context() is tp.ring.crt and tp.ntt_operators() is tp.ring.limbs


def test_builder_and_constructors(system):
    jp, tp, *_ = system
    b = (P.PvwParametersBuilder().set_parties(4).set_dimension(6).set_l(8).set_moduli(MODULI)
         .set_secret_variance(2.0).set_error_bound_1(90).set_error_bound_2(300))
    assert b.build_arc() == b.build() == tp
    assert P.PvwParameters.new_with_u32_bounds(4, 6, 8, MODULI, 2.0, 90, 300) == tp
    assert J.PvwParameters.new_with_u32_bounds(4, 6, 8, MODULI, 2.0, 90, 300) == jp


# --------------------------------------------------------------------------
# Poly
# --------------------------------------------------------------------------

def test_poly_mul_equals_jax(system):
    jp, tp, key, *_ = system
    ja = J.Poly.random(jp.ring, NTT, jax.random.fold_in(key, 40), (3, 2))
    jb = J.Poly.random(jp.ring, NTT, jax.random.fold_in(key, 41), (3, 2))
    ta, tb = (P.Poly.from_residues_np(x.residues_np(), tp.ring, NTT, device="cpu")
              for x in (ja, jb))
    residues_equal(ta * tb, ja * jb)
    with pytest.raises(PolynomialError, match="Ntt"):
        ta.to_power_basis() * tb.to_power_basis()
    with pytest.raises(PolynomialError, match="representation"):
        ta * tb.to_power_basis()


def test_poly_random_from_seed_and_lift_equal_jax(system):
    jp, tp, *_ = system
    seed = bytes(range(1, 33))
    for batch in ((), (2, 3)):
        residues_equal(P.Poly.random_from_seed(tp.ring, NTT, seed, batch, device="cpu"),
                       J.Poly.random_from_seed(jp.ring, NTT, seed, batch))
    jx = J.Poly.random_from_seed(jp.ring, POWER, seed, (2,))
    tx = P.Poly.random_from_seed(tp.ring, POWER, seed, (2,), device="cpu")
    assert tx.representation() == POWER
    got, want = tx.coefficients_int(), jx.coefficients_int()
    assert got.shape == want.shape == (2, jp.l) and got.tolist() == want.tolist()
    assert all(0 <= v < tp.q_total() for v in got.ravel())
    with pytest.raises(PolynomialError):
        tx.to_ntt().coefficients_int()


def test_poly_stack_equals_jax(system):
    jp, tp, key, *_ = system
    js = [J.Poly.random(jp.ring, NTT, jax.random.fold_in(key, 60 + i), (2,)) for i in range(3)]
    ts = [P.Poly.from_residues_np(x.residues_np(), tp.ring, NTT, device="cpu") for x in js]
    for axis in (0, 1):
        st = tpoly.stack(ts, axis=axis)
        residues_equal(st, jpoly.stack(js, axis=axis))
        assert st.batch_shape == ((3, 2) if axis == 0 else (2, 3))
    with pytest.raises(PolynomialError, match="empty"):
        tpoly.stack([])
    with pytest.raises(PolynomialError, match="representation"):
        tpoly.stack([ts[0], ts[1].to_power_basis()])
    assert torch.equal(tpoly.stack(ts[:1]).res[0], ts[0].res)
