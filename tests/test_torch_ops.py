"""Parity of the PyTorch port's arithmetic layer with the JAX package.

Same inputs, made with numpy from a seed, go through ``pvw_tpu`` and
``pvw_tpu_torch`` on the CPU. Every output is an integer residue, digit
or table entry, so the tolerance is exact equality.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pvw_tpu.ops import modmat as jmm
from pvw_tpu.ops import ntt as jntt
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.parameters import PvwParameters as JParams
from pvw_tpu.params.ring import RingPlan as JRing
from pvw_tpu_torch.ops import modmat as tmm
from pvw_tpu_torch.ops import ntt as tntt
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.parameters import PvwParameters as TParams
from pvw_tpu_torch.params.ring import RingPlan as TRing

MODULI = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)
TOY = (0xFFFFC4001, 0x1FFFFE0001)
BIG = (0x800000022A0001, 0x800000021A0001)   # 55-bit, nd = 8


def rand_u64(rng, shape):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=shape, dtype=np.uint64)


def residues(rng, shape, moduli):
    """Canonical residues [..., L, ...] with the limb axis at position 0."""
    qs = np.array(moduli, np.uint64).reshape((-1,) + (1,) * (len(shape) - 1))
    return rand_u64(rng, shape) % qs


def pairs(x):
    hi, lo = ju.split_u64_np(x)
    return jnp.asarray(hi), jnp.asarray(lo)


def ints(hi, lo):
    return ju.join_u64_np(np.asarray(hi), np.asarray(lo))


def T(x):
    return tu.u64_tensor(x)


def N(t):
    return tu.u64_numpy(t)


# --------------------------------------------------------------------------
# u64 lanes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("moduli", [MODULI, BIG])
def test_shoup_and_mulhi_against_python_ints(moduli):
    rng = np.random.default_rng(1)
    for q in moduli:
        x = rand_u64(rng, (300,))
        x[:3] = [0, (1 << 64) - 1, 1 << 63]
        w = rand_u64(rng, (300,)) % np.uint64(q)
        wp = np.array([(int(v) << 64) // q for v in w], dtype=object)
        wp = (wp & 0xFFFFFFFFFFFFFFFF).astype(np.uint64)
        got = N(tu.shoup_mul64_arr(T(x), T(w), T(wp), q))
        want = np.array([int(a) * int(b) % q for a, b in zip(x, w)], np.uint64)
        np.testing.assert_array_equal(got, want)
        hi = N(tu.mulhi64(T(x), T(wp)))
        np.testing.assert_array_equal(
            hi, np.array([(int(a) * int(b)) >> 64 for a, b in zip(x, wp)], np.uint64))
        x32 = x & np.uint64(0xFFFFFFFF)
        wp32 = np.array([(int(v) << 32) // q for v in w], np.uint64)
        got32 = N(tu.shoup_mul32_arr(T(x32), T(w), T(wp32), q))
        np.testing.assert_array_equal(
            got32, np.array([int(a) * int(b) % q for a, b in zip(x32, w)], np.uint64))


@pytest.mark.parametrize("moduli", [MODULI, BIG])
def test_addsubneg_mod_against_jax(moduli):
    rng = np.random.default_rng(2)
    q = moduli[-1]
    a = rand_u64(rng, (200,)) % np.uint64(q)
    b = rand_u64(rng, (200,)) % np.uint64(q)
    a[:2] = [0, q - 1]
    b[:2] = [q - 1, 0]
    qh, ql = ju.const_pair(q)
    for tfn, jfn in ((tu.addmod, ju.addmod), (tu.submod, ju.submod)):
        np.testing.assert_array_equal(N(tfn(T(a), T(b), q)),
                                      ints(*jfn(*pairs(a), *pairs(b), qh, ql)))
    np.testing.assert_array_equal(N(tu.negmod(T(a), q)),
                                  ints(*ju.negmod(*pairs(a), qh, ql)))


@pytest.mark.parametrize("nd", [1, 3, 5, 8])
def test_signed_digits_against_jax(nd):
    rng = np.random.default_rng(3)
    if nd == 8:
        x = rand_u64(rng, (400,))          # full u64: the `as i64` wrap
    else:
        x = rng.integers(0, 127 << (8 * (nd - 1)), size=(400,), dtype=np.uint64)
    got = tu.to_signed_digits(T(x), nd).numpy()
    want = np.asarray(ju.to_signed_digits(*pairs(x), nd))
    np.testing.assert_array_equal(got, want)


def test_digits_for_max_against_jax():
    for v in (0, 126, 127, 0xFFFF, (1 << 37) - 1, (1 << 55), (1 << 64) - 1):
        assert tu.digits_for_max(v) == ju.digits_for_max(v)


@pytest.mark.parametrize("moduli,ncols", [(MODULI, 5), (MODULI, 9), (BIG, 15), (TOY, 4)])
def test_column_folds_exact(moduli, ncols):
    rng = np.random.default_rng(4)
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    L = tr.num_limbs
    cols = rng.integers(-(1 << 31), 1 << 31, size=(L, 40, ncols), dtype=np.int64)
    cols[:, 0] = -(1 << 31)
    cols[:, 1] = (1 << 31) - 1
    cols = cols.astype(np.int32)
    want = np.array([[sum(int(cols[i, e, c]) << (8 * c) for c in range(ncols)) % q
                      for e in range(40)] for i, q in enumerate(moduli)], np.uint64)
    shp = (L, 1)
    q = T(tr.q).reshape(shp)
    bias = T(tr.bias_for_columns(ncols)).reshape(shp)
    got = tu.fold_columns_grouped(torch.from_numpy(cols), T(tr.grp_w).reshape(L, 1, 4),
                                  T(tr.grp_s).reshape(L, 1, 4), bias, q)
    np.testing.assert_array_equal(N(got), want)
    np.testing.assert_array_equal(
        N(tmm._fold_leading(torch.from_numpy(cols), tr)),
        ints(*jmm._fold_leading(jnp.asarray(cols), jr)))
    if tr.fold_words_ok:
        got = tu.fold_columns_words(torch.from_numpy(cols), T(tr.wrd_w).reshape(L, 1, 4),
                                    T(tr.wrd_wp32).reshape(L, 1, 4), bias, q)
        np.testing.assert_array_equal(N(got), want)


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

@pytest.mark.parametrize("moduli,l", [(TOY, 8), (MODULI, 8), (BIG, 16)])
def test_ring_tables_equal_jax(moduli, l):
    tr, jr = TRing(moduli, l), JRing(moduli, l)
    assert (tr.num_digits, tr.num_columns, tr.fold_words_ok, tr.q_total) == \
        (jr.num_digits, jr.num_columns, jr.fold_words_ok, jr.q_total)
    eq = np.testing.assert_array_equal
    eq(tr.q, ju.join_u64_np(jr.q_hi, jr.q_lo))
    eq(tr.pow_w, ju.join_u64_np(jr.pow_hi, jr.pow_lo))
    eq(tr.pow_wp32, jr.pow_wp32)
    eq(tr.pow_s64, ju.join_u64_np(jr.pow_s64_hi, jr.pow_s64_lo))
    eq(tr.grp_w, ju.join_u64_np(jr.grp_hi, jr.grp_lo))
    eq(tr.grp_s, ju.join_u64_np(jr.grp_sh, jr.grp_sl))
    eq(tr.bias, ju.join_u64_np(jr.bias_hi, jr.bias_lo))
    eq(tr.wrd_w, ju.join_u64_np(jr.wrd_hi, jr.wrd_lo))
    eq(tr.wrd_wp32, jr.wrd_wp32)
    for tl, jl in zip(tr.limbs, jr.limbs):
        assert tl.psi == jl.psi
        eq(tl.ntt_fwd, jl.ntt_fwd)
        eq(tl.ntt_inv, jl.ntt_inv)
    eq(tr.ntt_fwd_band, jr.ntt_fwd_band)
    eq(tr.ntt_inv_band, jr.ntt_inv_band)
    for j in (1, 2):
        eq(tr.ntt_band_jr("fwd", j), jr.ntt_band_jr("fwd", j))
        eq(tr.ntt_scaled_tab(j), jr.ntt_scaled_tab(j))
    nd = tr.num_digits
    eq(tr.bias_for_columns(nd), ju.join_u64_np(*jr.bias_pair_for_columns(nd)))
    coeffs = [-(1 << 80), -1, 0, 1, 12345, 1 << 70] + [7] * (l - 6)
    eq(tr.residues_from_int_coeffs(coeffs), jr.residues_from_int_coeffs(coeffs))
    res = tr.residues_from_int_coeffs(coeffs)
    assert tr.lift_to_ints(res) == jr.lift_to_ints(res)


@pytest.mark.parametrize("n,k,moduli", [(7, 32, TOY), (4, 8, MODULI), (3, 16, BIG)])
def test_parameter_tables_equal_jax(n, k, moduli):
    bounds = TParams.suggest_error_bounds(n, k, 8, moduli, 0.5)
    assert bounds == JParams.suggest_error_bounds(n, k, 8, moduli, 0.5)
    tp = TParams(n, k, 8, moduli, 0.5, *bounds)
    jp = JParams(n, k, 8, moduli, 0.5, *bounds)
    assert tp.to_dict() == jp.to_dict()
    assert (tp.delta(), tp.delta_power_l_minus_1(), tp.q_total()) == \
        (jp.delta(), jp.delta_power_l_minus_1(), jp.q_total())
    assert tp.verify_correctness_condition() == jp.verify_correctness_condition()
    assert tp.verify_parameters() == jp.verify_parameters()
    assert tp.gadget_vector() == jp.gadget_vector()
    for name in ("gadget_ntt", "gadget_ntt_shoup", "gadget_wrap",
                 "gadget_wrap_shoup", "gadget_ntt_dig"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))


# --------------------------------------------------------------------------
# digit matmuls and NTTs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("moduli", [TOY, BIG])
def test_prescale_band_and_lhs_planes_equal_jax(moduli):
    rng = np.random.default_rng(5)
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    L, S = tr.num_limbs, 8
    b = residues(rng, (L, S, 6, 4), moduli)
    np.testing.assert_array_equal(tmm.prescale_digits_band(T(b), tr).numpy(),
                                  np.asarray(jmm.prescale_digits_band(pairs(b), jr)))
    a = np.moveaxis(residues(rng, (L, 5, 6, S), moduli), 0, 2)     # [m, k, L, l]
    np.testing.assert_array_equal(tmm.lhs_digit_planes(T(a), tr).numpy(),
                                  np.asarray(jmm.lhs_digit_planes(*pairs(a), jr)))


@pytest.mark.parametrize("moduli", [MODULI, BIG])
def test_matmul_channels_equal_jax(moduli):
    rng = np.random.default_rng(6)
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    L = tr.num_limbs
    a = residues(rng, (L, 8, 3, 7), moduli)
    b = residues(rng, (L, 8, 7, 5), moduli)
    got = N(tmm.matmul_channels(T(a), T(b), tr))
    np.testing.assert_array_equal(got, ints(*jmm.matmul_channels(pairs(a), pairs(b), jr)))
    want = np.zeros_like(got)
    for i, q in enumerate(moduli):
        for s in range(8):
            want[i, s] = np.array((a[i, s].astype(object) @ b[i, s].astype(object)) % q,
                                  np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("moduli", [MODULI, BIG])
def test_ntt_forward_inverse_equal_jax(moduli):
    rng = np.random.default_rng(8)
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    x = np.moveaxis(residues(rng, (tr.num_limbs, 3, 4, 8), moduli), 0, 2)   # [3, 4, L, l]
    fwd = tntt.ntt_forward(T(x), tr)
    np.testing.assert_array_equal(N(fwd), ints(*jntt.ntt_forward(pairs(x), jr)))
    np.testing.assert_array_equal(N(tntt.ntt_inverse(fwd, tr)), x)


@pytest.mark.parametrize("bound", [1, 127, 2000, 32639])
def test_ntt_forward_signed_ch_equal_jax(bound):
    rng = np.random.default_rng(9)
    tr, jr = TRing(MODULI, 8), JRing(MODULI, 8)
    c = rng.integers(-bound, bound + 1, size=(5, 3, 8)).astype(np.int32)
    got = N(tntt.ntt_forward_signed_ch(torch.from_numpy(c), tr, bound))
    np.testing.assert_array_equal(
        got, ints(*jntt.ntt_forward_signed_ch(jnp.asarray(c), jr, bound)))
    assert got.shape == (3, 8, 5, 3)
    np.testing.assert_array_equal(
        N(tntt.ntt_forward_signed(torch.from_numpy(c), tr, bound)),
        ints(*jntt.ntt_forward_signed(jnp.asarray(c), jr, bound)))


def test_exact_int_matmul_is_exact():
    rng = np.random.default_rng(10)
    a = rng.integers(-128, 128, size=(2, 9, 1280), dtype=np.int64).astype(np.int8)
    b = rng.integers(-128, 128, size=(2, 1280, 11), dtype=np.int64).astype(np.int8)
    a[0, 0] = -128
    b[0, :, 0] = -128                       # the largest column: 1280 * 2^14
    got = tmm.exact_int_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    assert int(got[0, 0, 0]) == 1280 * (1 << 14)
    with pytest.raises(TypeError):
        tmm.exact_int_matmul(torch.from_numpy(a).int(), torch.from_numpy(b))


def test_poly_ring_ops_equal_jax():
    from pvw_tpu.poly import Poly as JPoly
    from pvw_tpu.poly import Representation as JRep
    from pvw_tpu_torch.poly import Poly as TPoly
    from pvw_tpu_torch.poly import Representation as TRep

    rng = np.random.default_rng(11)
    tr, jr = TRing(MODULI, 8), JRing(MODULI, 8)
    a = np.moveaxis(residues(rng, (3, 2, 8), MODULI), 0, 1)        # [2, L, l]
    b = np.moveaxis(residues(rng, (3, 2, 8), MODULI), 0, 1)
    ta = TPoly.from_residues_np(a, tr, TRep.PowerBasis, device="cpu")
    tb = TPoly.from_residues_np(b, tr, TRep.PowerBasis, device="cpu")
    ja = JPoly.from_residues_np(a, jr, JRep.PowerBasis)
    jb = JPoly.from_residues_np(b, jr, JRep.PowerBasis)
    for got, want in ((ta + tb, ja + jb), (ta - tb, ja - jb), (-ta, -ja),
                      (ta.to_ntt(), ja.to_ntt())):
        np.testing.assert_array_equal(got.residues_np(), want.residues_np())
    assert ta.to_ntt().to_power_basis() == ta
    c = np.array([[-3, 0, 1, 127, -128, 5, -1, 2]], np.int32)
    np.testing.assert_array_equal(
        TPoly.from_coefficients(c, tr, device="cpu").residues_np(),
        JPoly.from_coefficients(c, jr).residues_np())
    ch = TPoly.from_channel_major(ta.channel(), TRep.PowerBasis, tr)
    assert ch.is_channel_major and ch.batch_shape == (2,) and ch[1] == ta[1]
