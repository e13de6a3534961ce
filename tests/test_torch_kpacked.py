"""The k-packed band and the 16-byte row pitch of the Hopper kernels'
operands, on the CPU, against the n-major band and the JAX package.

Kernels 1 and 3 read both int8 operands k-contiguous through TMA, so
kernel 4 writes the band k-packed: storage [L, S, nd, n, kd_pad] (kd_pad =
k*nd rounded up to 16, zero pads) handed on as the strided view
[L, S, nd, kd, n]. On the CPU ``ntt_prescale_band``'s twin lays its band out
the same way (``prescale_digits_band`` does), and the entries relay any
other layout once, counted in ``fused_modmat.band_relayouts``, so every
layout step runs here. Residues and band bytes: exact equality, against the
n-major band and the Pallas kernels in interpret mode. The CUDA kernels are
held against their twins in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pvw_tpu.ops import pallas_modmat as jpm
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.ring import RingPlan as JRing
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import modmat as tmm
from pvw_tpu_torch.ops import ntt as tntt
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import RingPlan as TRing
from pvw_tpu_torch.utils.intmath import generate_ntt_primes

TOY = (0xFFFFC4001, 0x1FFFFE0001)                                   # nd = 5
CHAIN_55X4 = (0x80000000080001, 0x80000000130001, 0x80000000190001, 0x800000001D0001)
CHAIN_BY_ND = {1: (97, 113), **{nd: generate_ntt_primes(bits, 2, 8) for nd, bits in
                                 ((2, 14), (3, 22), (4, 30), (5, 38), (6, 46), (7, 54),
                                  (8, 61))}}
KEY = (0xDEADBEEF, 0x12345678)


def rand_u64(rng, shape):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=shape, dtype=np.uint64)


def storage(band):
    """The rows [..., n, kd_pad] under a k-packed band view, pads included."""
    rows = band.transpose(-1, -2)
    pad = rows.stride(-2)
    return torch.as_strided(rows, (*rows.shape[:-1], pad), rows.stride(),
                            rows.storage_offset())


def operands(moduli, m, k, n, seed, l=8):
    """Residue operands a [L, l, m, k] and b [L, l, k, n] (numpy), the lhs
    digit planes and the band of b (k-packed)."""
    tr = TRing(moduli, l)
    L, nd = tr.num_limbs, tr.num_digits
    rng = np.random.default_rng(seed)
    a = rand_u64(rng, (L, l, m, k)) % tr.q.reshape(L, 1, 1, 1)
    b = rand_u64(rng, (L, l, k, n)) % tr.q.reshape(L, 1, 1, 1)
    lhs_dig = tmm.digits(tu.u64_tensor(a), nd).reshape(L, l, m, k * nd)
    return tr, rng, a, b, lhs_dig, tmm.prescale_digits_band(tu.u64_tensor(b), tr)


def encode_pair(rng, moduli, m, n, l=8):
    """The port's and the JAX kernel's 64-bit encode operands."""
    sc = rand_u64(rng, (m, n))
    sc[0, :3] = [0, 1 << 63, (1 << 64) - 1]
    q = np.array(moduli, np.uint64)[:, None]
    g = rand_u64(rng, (len(moduli), l)) % q
    gs = np.array([[(int(g[i, s]) << 64) // mq for s in range(l)]
                   for i, mq in enumerate(moduli)], object)
    gs = (gs & 0xFFFFFFFFFFFFFFFF).astype(np.uint64)
    wrap = np.array([[pow(2, 64, mq) * int(g[i, s]) % mq for s in range(l)]
                     for i, mq in enumerate(moduli)], np.uint64)
    return ((tu.u64_tensor(sc), tu.u64_tensor(tfm.encode_tab(g, gs, wrap))),
            (*map(jnp.asarray, ju.split_u64_np(sc)),
             jnp.asarray(jpm.encode_tab(g, gs, wrap, moduli))))


def jax_kernel1(tr, lhs_dig, band, noise, jr, vals, encode=None, post=None, seeds=None,
                gen=None, masked=False):
    """Interpret-mode ``_fused_scaled_noise_matmul`` (8 x 4 tiles) on the
    port's operands -> uint64 [L, l, m, n]."""
    jring = JRing(tr.moduli, tr.degree)
    L, l, m, kd = lhs_dig.shape
    nd, n = band.shape[2], band.shape[4]
    tables = jnp.repeat(jnp.asarray(jpm._pack_tables(jring, nd)), l, axis=0)
    ntab = jnp.asarray(jring.ntt_scaled_tab(1 if vals else jr), jnp.int32).reshape(
        L * l, l * (1 if vals else jr), nd)
    oh, ol = jpm._fused_scaled_noise_matmul(
        jnp.asarray(lhs_dig.reshape(L * l, m, kd).numpy()),
        jnp.asarray(band.reshape(L * l, nd, kd, n).numpy()), tables, ntab,
        None if noise is None else jnp.asarray(noise.numpy()), post, encode, 8, 4, True,
        jring.fold_words_ok, False, None if seeds is None else jnp.asarray(seeds), gen,
        l if vals else 0, jr if vals and noise is not None else 0, False, masked)
    return ju.join_u64_np(np.asarray(oh), np.asarray(ol)).reshape(L, l, m, n)


# --------------------------------------------------------------------------
# the band kernel 4 hands on
# --------------------------------------------------------------------------

@pytest.mark.parametrize("moduli,bound,k,d", [(TOY, 1, 3, 20), (CHAIN_55X4, 200, 4, 9)])
def test_kpacked_band_equals_n_major_and_pallas(moduli, bound, k, d):
    """``ntt_prescale_band`` (the twin's band laid out k-packed) holds the
    values of the n-major twin band and of the interpret-mode Pallas
    kernel: k*nd = 15 and 28, neither a multiple of 16."""
    rng = np.random.default_rng(k)
    c = rng.integers(-bound, bound + 1, (k, d, 8)).astype(np.int32)
    tr = TRing(moduli, 8)
    got = tfm.ntt_prescale_band(torch.from_numpy(c), tr, bound)
    plain = tfm.ntt_prescale_band_plain(torch.from_numpy(c), tr, bound)
    assert got.stride(-2) == 1 and not got.is_contiguous()
    assert torch.equal(got, plain.contiguous())
    want = jpm.ntt_prescale_band(jnp.asarray(c), JRing(moduli, 8), bound, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [2, 3, 16])
@pytest.mark.parametrize("nd", range(1, 9))
def test_kpacked_band_strides_and_zero_pads(nd, k):
    """Every nd and k*nd on and off 16 bytes: k contiguous, every other
    stride and the base on 16 bytes (TMA's terms), the pad bytes zero, the
    same values as the n-major band."""
    tr = TRing(CHAIN_BY_ND[nd], 8)
    c = torch.from_numpy(np.random.default_rng(nd).integers(-1, 2, (k, 5, 8)).astype(np.int32))
    band = tfm.ntt_prescale_band(c, tr, 1)
    kd = k * nd
    assert band.shape == (tr.num_limbs, 8, nd, kd, 5)
    assert band.stride(-2) == 1 and band.data_ptr() % 16 == 0
    assert all(s % 16 == 0 for i, s in enumerate(band.stride()) if i != band.dim() - 2)
    rows = storage(band)
    assert rows.shape[-1] == -(-kd // 16) * 16
    assert not rows[..., kd:].any()
    assert torch.equal(band, tfm.ntt_prescale_band_plain(c, tr, 1))
    assert torch.equal(tmm.k_rows(band.contiguous().transpose(-1, -2)).transpose(-1, -2),
                       band)


def test_k_rows_pads_only_where_needed():
    """``k_rows`` takes rows with a 16-byte pitch as they lie and pads the
    others (zeros) into such a view of the same values; the key-plane cache
    gives the encryption operands that pitch once."""
    x = torch.arange(3 * 5 * 32, dtype=torch.int64).reshape(3, 5, 32).to(torch.int8)
    assert tmm.k_rows(x) is x
    y = x[..., :20].contiguous()
    z = tmm.k_rows(y)
    assert torch.equal(z, y) and z.stride() == (5 * 32, 32, 1)
    assert not storage(z.transpose(-1, -2))[..., 20:].any()
    from pvw_tpu_torch.keys.public_key import GlobalPublicKey
    from pvw_tpu_torch.params.crs import PvwCrs
    from pvw_tpu_torch.params.parameters import PvwParametersBuilder

    p = (PvwParametersBuilder().set_parties(4).set_dimension(3).set_l(8)
         .set_moduli(TOY).set_secret_variance(0.5).set_error_bounds_u32(50, 50).build())
    gpk = GlobalPublicKey(PvwCrs.new_deterministic(p, bytes(32), device="cpu"))
    for ops in (gpk.encrypt_operands(), gpk.encrypt_operands_swapped()):
        for t in ops:
            assert tmm.k_rows_ok(t) and t.shape[-1] == 15      # k*nd = 3*5


# --------------------------------------------------------------------------
# the entries of kernels 1 and 3 on the k-packed band
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nd", range(1, 9))
def test_entry_kpacked_equals_n_major(nd):
    """``matmul_fold_scaled`` at every nd, m and n off the 64 x 32 tile,
    k*nd off 16 bytes, noise rows and the 64-bit encode: the same residues
    on the k-packed band of ``prescale_digits_band`` (taken as it lies) as
    on an n-major copy (relaid once, counted)."""
    moduli = CHAIN_BY_ND[nd]
    tr, rng, _, _, lhs_dig, band = operands(moduli, 70, 3, 33, 10 + nd)
    jr = 2 - nd % 2
    bound = 50 if jr == 1 else 2000
    ev = rng.integers(-bound, bound + 1, (70, 33, 8)).astype(np.int32)
    noise = tntt._digit_planes(torch.from_numpy(ev), jr)
    enc, _ = encode_pair(rng, moduli, 70, 33)
    before = tfm.band_relayouts
    got = [tfm.matmul_fold_scaled(None, b, tr, noise=noise, encode=enc, lhs_dig=lhs_dig,
                                  noise_bound=bound)
           for b in (band, band.contiguous())]
    assert tfm.band_relayouts == before + 1
    assert torch.equal(got[0], got[1])


@pytest.mark.parametrize("moduli,jr,vals", [(TOY, 1, True), (CHAIN_55X4, 2, False),
                                            (CHAIN_BY_ND[8], 2, True)])
def test_kernel1_twin_on_kpacked_band_equals_pallas(moduli, jr, vals):
    """Kernel 1's twin on the k-packed band against the interpret-mode
    Pallas kernel (on its 8 x 4 tiles): value and digit noise rows, the
    64-bit encode, k*nd off 16 bytes, m and n off the CUDA tile."""
    tr, rng, _, _, lhs_dig, band = operands(moduli, 16, 3, 12, 20 + jr)
    bound = 50 if jr == 1 else 2000
    ev = rng.integers(-bound, bound + 1, (16, 12, 8)).astype(np.int32)
    noise = tntt._digit_planes(torch.from_numpy(ev), jr)
    enc, jenc = encode_pair(rng, moduli, 16, 12)
    tsettings.noise_value_mac = vals
    try:
        got = tfm.matmul_fold_scaled(None, band, tr, noise=noise,
                                     encode=enc, lhs_dig=lhs_dig, noise_bound=bound)
    finally:
        del tsettings.noise_value_mac
    want = jax_kernel1(tr, lhs_dig, band, noise, jr, vals, encode=jenc)
    np.testing.assert_array_equal(tu.u64_numpy(got), want)


def test_masked_post_on_kpacked_band_equals_pallas():
    """The masked form with ``post=`` on the k-packed band against the
    interpret-mode Pallas kernel's ``masked=True`` with a post input."""
    tr, rng, _, _, lhs_dig, band = operands(TOY, 16, 3, 8, 30)
    enc, jenc = encode_pair(rng, TOY, 16, 8)
    post = rand_u64(rng, (2, 8, 16, 8)) % tr.q.reshape(2, 1, 1, 1)
    seeds = np.array([*KEY, 2, 3, 12, 5], np.uint32).astype(np.int32)
    got = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig,
                                 encode=enc, post=tu.u64_tensor(post),
                                 gen_noise=(torch.from_numpy(seeds), 1, 100, "tfry"))
    ph, pl = ju.split_u64_np(post.reshape(16, 16, 8))
    want = jax_kernel1(tr, lhs_dig, band, None, 1, False, encode=jenc,
                       post=(jnp.asarray(ph), jnp.asarray(pl)), seeds=seeds,
                       gen=(8, 1, 100, True), masked=True)
    np.testing.assert_array_equal(tu.u64_numpy(got), want)


def test_pipelined_twin_on_kpacked_band_equals_pallas():
    """Kernel 3's twin (the pipelined route's function) on the k-packed band
    against the interpret-mode ``_fused_pipelined_matmul`` with in-kernel
    v3k and the encode."""
    tr, rng, _, _, lhs_dig, band = operands(TOY, 16, 3, 8, 40)
    jring = JRing(TOY, 8)
    L, l, nd, kd = 2, 8, 5, 15
    enc, jenc = encode_pair(rng, TOY, 16, 8)
    seeds = np.array([*KEY, 5, 9], np.uint32).astype(np.int32)
    tsettings.pipeline_fold = True
    try:
        got = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig,
                                     encode=enc, gen_noise=(torch.from_numpy(seeds), 1, 100,
                                                            "tfry"))
    finally:
        del tsettings.pipeline_fold
    tables = jnp.repeat(jnp.asarray(jpm._pack_tables(jring, nd)), l, axis=0)
    ntab = jnp.asarray(jring.ntt_scaled_tab(1), jnp.int32).reshape(L * l, l, nd)
    oh, ol = jpm._fused_pipelined_matmul(
        jnp.asarray(lhs_dig.reshape(L * l, 16, kd).numpy()),
        jnp.asarray(band.reshape(L * l, nd, kd, 8).numpy()), tables, ntab, None, jenc, 8, 8,
        True, jring.fold_words_ok, False, jnp.asarray(seeds), (l, 1, 100, True))
    np.testing.assert_array_equal(tu.u64_numpy(got),
                                  ju.join_u64_np(np.asarray(oh), np.asarray(ol))
                                  .reshape(L, l, 16, 8))


def test_swapped_twin_on_padded_rows_equals_pallas():
    """The swapped form's operands at k*nd = 15 (the rhs laid out k-packed
    with a padded pitch, as the kernel reads it) against the interpret-mode
    Pallas swapped variant."""
    tr, rng, a, b, _, _ = operands(TOY, 16, 3, 128, 50)
    planes = tmm.k_rows(tmm.lhs_scaled_planes(tu.u64_tensor(a).permute(2, 3, 0, 1), tr))
    rd = tmm.rhs_digit_cols(tu.u64_tensor(b), tr)
    noise = torch.from_numpy(rng.integers(-100, 101, (8, 16, 128)).astype(np.int8))
    got = tfm.matmul_fold_swapped(planes, rd, tr, noise=noise, noise_bound=100)
    wh, wl = jpm.matmul_fold_swapped(jnp.asarray(planes.numpy()), jnp.asarray(rd.numpy()),
                                     JRing(TOY, 8), noise=jnp.asarray(noise.numpy()),
                                     noise_bound=100, interpret=True)
    np.testing.assert_array_equal(tu.u64_numpy(got), ju.join_u64_np(np.asarray(wh),
                                                                    np.asarray(wl)))


def test_band_relayouts_counts_the_n_major_inputs():
    """Kernel 4's k-packed band and ``prescale_digits_band``'s are taken as
    they lie on every route; a band of another layout (an n-major
    contiguous copy) is relaid once a call, counted; an encryption (keygen
    before it) relays nothing."""
    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R

    tr, _, _, b, lhs_dig, band = operands(TOY, 9, 3, 7, 60)
    kp = tfm.ntt_prescale_band(torch.from_numpy(
        np.random.default_rng(1).integers(-1, 2, (3, 7, 8)).astype(np.int32)), tr, 1)
    before = tfm.band_relayouts
    for route in (False, True):
        tsettings.pipeline_fold = route
        try:
            tfm.matmul_fold_scaled(None, kp, tr, lhs_dig=lhs_dig)
            tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig)
            tfm.matmul_fold_scaled(None, band.contiguous(), tr, lhs_dig=lhs_dig)
            tfm.matmul_fold_scaled(None, kp.contiguous(), tr, lhs_dig=lhs_dig)
        finally:
            del tsettings.pipeline_fold
    assert tfm.band_relayouts == before + 4
    p = (P.PvwParametersBuilder().set_parties(4).set_dimension(3).set_l(8).set_moduli(TOY)
         .set_secret_variance(0.5).set_error_bounds_u32(50, 50).build())
    crs = P.PvwCrs.new_deterministic(p, bytes(32), device="cpu")
    parties = [P.Party.new(i, p, R.fold_in(R.key(3), i), device="cpu") for i in range(4)]
    gpk = P.GlobalPublicKey(crs)
    before = tfm.band_relayouts
    gpk.generate_all_party_keys(parties, R.key(4))
    P.encrypt_batch(np.arange(8, dtype=np.uint64).reshape(2, 4), gpk, R.key(5))
    assert tfm.band_relayouts == before


@pytest.mark.parametrize("nd,k", [(5, 3), (8, 2), (3, 16)])
def test_rhs_digit_cols_kpacked(nd, k):
    """The swapped form's rhs digits come k-packed like the band (storage
    [L, l, n, kd_pad], zero pads, 16-byte strides) with the values of the
    n-major stack of the digit list, so the entry takes them as they lie."""
    tr = TRing(CHAIN_BY_ND[nd], 8)
    r = tu.u64_tensor(rand_u64(np.random.default_rng(nd), (tr.num_limbs, 8, k, 7))
                      % tr.q.reshape(-1, 1, 1, 1))
    got = tmm.rhs_digit_cols(r, tr)
    want = torch.stack(tu.to_signed_digit_list(r, nd), dim=3).reshape(tr.num_limbs, 8,
                                                                      k * nd, 7)
    assert torch.equal(got, want)
    assert tmm.k_rows_ok(got.transpose(-1, -2))
    assert not storage(got)[..., k * nd:].any()


def test_row_relayouts_counts_the_unpadded_lhs():
    """lhs rows without the 16-byte pitch (k*nd = 15) are copied once a
    call by the entries, counted in ``row_relayouts``, on both routes and
    in the swapped form; rows laid out by ``k_rows`` are taken as they lie;
    the swapped rhs of ``rhs_digit_cols`` is taken as it lies and an
    n-major copy relaid, counted in ``band_relayouts``."""
    tr, _, a, b, lhs_dig, band = operands(TOY, 9, 3, 7, 61)
    padded = tmm.k_rows(lhs_dig)
    before = tfm.row_relayouts
    for route in (False, True):
        tsettings.pipeline_fold = route
        try:
            want = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig)
            assert torch.equal(tfm.matmul_fold_scaled(None, band, tr, lhs_dig=padded), want)
        finally:
            del tsettings.pipeline_fold
    assert tfm.row_relayouts == before + 2
    planes = tmm.lhs_scaled_planes(tu.u64_tensor(a).permute(2, 3, 0, 1), tr)
    rd = tmm.rhs_digit_cols(tu.u64_tensor(b), tr)
    before, bands = tfm.row_relayouts, tfm.band_relayouts
    want = tfm.matmul_fold_swapped(planes, rd, tr)
    assert (tfm.row_relayouts, tfm.band_relayouts) == (before + 1, bands)
    assert torch.equal(tfm.matmul_fold_swapped(tmm.k_rows(planes), rd.contiguous(), tr), want)
    assert (tfm.row_relayouts, tfm.band_relayouts) == (before + 1, bands + 1)


def test_launch_wrappers_refuse_unlaid_operands():
    """The launch wrappers lay nothing out: lhs rows without the 16-byte
    pitch, or an n-major band, raise before any launch (the entries lay
    operands out and count it)."""
    tr, _, _, _, lhs_dig, band = operands(TOY, 9, 3, 7, 62)
    L, l, m, kd = lhs_dig.shape
    nd, n = band.shape[2], band.shape[4]
    tables = torch.zeros((L * l, tfm.TABLE_WIDTH), dtype=torch.int64)
    ntab = torch.zeros((L * l, 1, nd), dtype=torch.int32)
    ld, bd = lhs_dig.reshape(L * l, m, kd), band.reshape(L * l, nd, kd, n)
    for lhs, b in ((ld, bd), (tmm.k_rows(ld), bd.contiguous())):
        with pytest.raises(ValueError, match="k_rows_ok"):
            tfm.fused_scaled_noise_matmul(lhs, b, tables, ntab, None, None, None, 1, False,
                                          False)
