"""One party's public key and the row API of B against the JAX package.

``PublicKey.generate`` (sᵀA + e, e from ``sample_error_1``) must give the
JAX package's residues and errors in both bound regimes: below the
smallest modulus (the threefry draw) and at or above it (the exact host
draw). ``add_public_key`` keeps the reference's ``num_keys`` quirk, the
``*_with_errors`` methods record the errors, and an encryption after a row
changes must use the new row (the operand cache is keyed on B's tensor).
"""

import numpy as np
import jax
import pytest

import pvw_tpu as J
import pvw_tpu_torch as P
from pvw_tpu_torch import convert
from pvw_tpu_torch.errors import DimensionMismatch, InvalidParameters

MODULI = (0xFFFFC4001, 0x1FFFFE0001)


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


def make_system(b1=None, n=5, k=8, seed=7):
    """n parties over a JAX CRS, and the port's copies on the CPU; the
    global keys of both packages empty."""
    bounds = J.PvwParameters.suggest_error_bounds(n, k, 8, MODULI, 0.5)
    jp = (J.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(8)
          .set_moduli(MODULI).set_secret_variance(0.5)
          .set_error_bounds_u32(b1 or bounds[0], bounds[1]).build())
    tp = convert.params_from_dict(jp.to_dict())
    key = jax.random.key(seed)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(key, 0))
    tcrs = convert.crs_from_residues(jcrs.matrix.residues_np(), tp, device="cpu")
    jparties = [J.Party.new(i, jp, jax.random.fold_in(key, 100 + i)) for i in range(n)]
    tparties = [P.Party(i, convert.secret_key_from_coeffs(p.secret_key.secret_coeffs, tp))
                for i, p in enumerate(jparties)]
    return jp, tp, key, jcrs, tcrs, jparties, tparties


def residues_equal(tpoly, jpoly):
    np.testing.assert_array_equal(tpoly.residues_np(), jpoly.residues_np())


@pytest.mark.parametrize("b1", [None, 1 << 40], ids=["below_min_q", "above_min_q"])
def test_generate_equals_jax(b1):
    jp, tp, key, jcrs, tcrs, jparties, tparties = make_system(b1)
    assert (jp.error_bound_1 >= min(MODULI)) == (b1 is not None)
    for i in (0, 3):
        ekey = jax.random.fold_in(key, 50 + i)
        jpk, jerr = J.PublicKey.generate(jparties[i].secret_key, jcrs, ekey)
        tpk, terr = P.PublicKey.generate(tparties[i].secret_key, tcrs, kw(ekey))
        residues_equal(tpk.key_polynomials, jpk.key_polynomials)
        residues_equal(terr, jerr)
        tpk.validate()
        assert tpk.dimension() == jp.k and tpk.polynomials() is tpk.key_polynomials
        residues_equal(tpk.get_polynomial(2), jpk.get_polynomial(2))
        assert tpk.get_polynomial(jp.k) is None
        # b - e is exactly sᵀA
        residues_equal(tpk.key_polynomials - terr,
                       jcrs.multiply_by_secret_key(jparties[i].secret_key))
    residues_equal(tparties[1].generate_public_key(tcrs, kw(key)).key_polynomials,
                   jparties[1].generate_public_key(jcrs, key).key_polynomials)


def test_generate_refuses_another_dimension():
    _, _, key, _, tcrs, _, _ = make_system()
    _, tp4, _, _, _, _, tparties4 = make_system(k=4)
    with pytest.raises(DimensionMismatch):
        P.PublicKey.generate(tparties4[0].secret_key, tcrs, kw(key))


def test_add_public_key_bounds_and_num_keys_quirk():
    jp, tp, key, jcrs, tcrs, jparties, tparties = make_system()
    tgpk, jgpk = P.GlobalPublicKey(tcrs), J.GlobalPublicKey(jcrs)
    for index in (3, 1):                       # num_keys is max(index) + 1, not a count
        ekey = jax.random.fold_in(key, index)
        tgpk.add_public_key(index, tparties[index].generate_public_key(tcrs, kw(ekey)))
        jgpk.add_public_key(index, jparties[index].generate_public_key(jcrs, ekey))
        assert tgpk.num_public_keys() == jgpk.num_keys == 4
    residues_equal(tgpk.matrix, jgpk.matrix)
    assert not tgpk.is_full()
    pk = tgpk.get_public_key(3)
    residues_equal(pk.key_polynomials, jgpk.get_public_key(3).key_polynomials)
    assert tgpk.get_public_key(4) is None is jgpk.get_public_key(4)
    residues_equal(tgpk.get_party_polynomials(1), jgpk.get_party_polynomials(1))
    with pytest.raises(InvalidParameters, match="not found"):
        tgpk.get_party_polynomials(4)
    with pytest.raises(InvalidParameters, match="exceeds maximum"):
        tgpk.add_public_key(jp.n, pk)
    short = P.PublicKey(pk.key_polynomials[:2], tp)
    with pytest.raises(InvalidParameters, match="dimension"):
        tgpk.add_public_key(0, short)


def test_generate_and_add_record_errors():
    jp, tp, key, jcrs, tcrs, jparties, tparties = make_system()
    tgpk, jgpk = P.GlobalPublicKey(tcrs), J.GlobalPublicKey(jcrs)
    k0, k2, k4 = (jax.random.fold_in(key, 200 + i) for i in (0, 2, 4))
    tgpk.generate_and_add(0, tparties[0].secret_key, kw(k0))
    jgpk.generate_and_add(0, jparties[0].secret_key, k0)
    tgpk.generate_and_add_with_errors(2, tparties[2].secret_key, kw(k2))
    jgpk.generate_and_add_with_errors(2, jparties[2].secret_key, k2)
    tgpk.generate_and_add_party_with_errors(tparties[4], kw(k4))
    jgpk.generate_and_add_party_with_errors(jparties[4], k4)
    tgpk.generate_and_add_party(tparties[1], kw(k0))
    jgpk.generate_and_add_party(jparties[1], k0)
    residues_equal(tgpk.matrix, jgpk.matrix)
    assert [e is None for e in tgpk.get_all_errors()] == \
        [e is None for e in jgpk.get_all_errors()] == [True, True, False, True, False]
    for i in (2, 4):
        residues_equal(tgpk.get_party_errors(i), jgpk.get_party_errors(i))
        # the recorded row is sᵀA + e
        want = tcrs.multiply_by_secret_key(tparties[i].secret_key) + tgpk.get_party_errors(i)
        residues_equal(tgpk.get_party_polynomials(i), want)
    assert tgpk.get_party_errors(0) is None and tgpk.get_party_errors(9) is None


def test_encryption_after_add_uses_the_new_row():
    """The encryption operands are cached on B's tensor: adding a key
    installs a new tensor, so the next encryption equals the JAX package's
    with the new row."""
    jp, tp, key, jcrs, tcrs, jparties, tparties = make_system()
    jgpk = J.GlobalPublicKey(jcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(key, 1))
    tgpk = P.GlobalPublicKey(tcrs)
    tgpk.generate_all_party_keys(tparties, kw(jax.random.fold_in(key, 1)))
    residues_equal(tgpk.matrix, jgpk.matrix)
    scalars = np.arange(1, jp.n + 1, dtype=np.uint64) * 1009
    ekey = jax.random.fold_in(key, 9)
    first = P.encrypt(scalars, tgpk, kw(ekey))
    residues_equal(first.c2, J.encrypt(scalars, jgpk, ekey).c2)
    planes = tgpk.encrypt_operands()
    old_matrix = tgpk.matrix.res
    rkey = jax.random.fold_in(key, 300)
    tgpk.generate_and_add_with_errors(2, tparties[2].secret_key, kw(rkey))
    jgpk.generate_and_add_with_errors(2, jparties[2].secret_key, rkey)
    assert tgpk.matrix.res is not old_matrix
    assert not np.array_equal(tgpk.matrix.residues_np()[2], old_matrix.numpy()[2])
    second, jsecond = P.encrypt(scalars, tgpk, kw(ekey)), J.encrypt(scalars, jgpk, ekey)
    assert tgpk.encrypt_operands()[1] is not planes[1]
    residues_equal(second.c1, jsecond.c1)
    residues_equal(second.c2, jsecond.c2)
    assert not np.array_equal(second.c2.residues_np()[2], first.c2.residues_np()[2])
    for i in range(jp.n):
        assert P.decrypt_party_value(second, tparties[i].secret_key, i) == int(scalars[i])
