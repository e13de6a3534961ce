"""Stream v3k through ``gen_noise`` in the port against the JAX package, on
the CPU.

``matmul_fold_scaled(gen_noise=(seeds, jr, bound, "tfry"))`` (the v3k
generator's plain twin on the CPU, then the fused matmul's) is held against
the Pallas kernel ``_fused_scaled_noise_matmul`` in interpret mode with
in-kernel v3k generation, as ``tests/test_v3k.py`` runs it. The routing of
``noise_stream`` and whole v3k encryptions through the entry points are
held against ``pvw_tpu``. Residues: exact equality. The CUDA generator is
held against its twin in ``tests/test_torch_cuda.py``.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pvw_tpu as J
from pvw_tpu.config import settings as jsettings
from pvw_tpu.ops import pallas_modmat as jpm
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.ring import RingPlan as JRing
import pvw_tpu_torch as P
from pvw_tpu_torch import convert
from pvw_tpu_torch import random as R
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.crypto import encryption as tenc
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import modmat as tmm
from pvw_tpu_torch.ops import ntt as tntt
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import RingPlan as TRing
from pvw_tpu_torch.utils.intmath import generate_ntt_primes

TOY = (0xFFFFC4001, 0x1FFFFE0001)
KEY = (0xDEADBEEF, 0x12345678)


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


def digit_operands(ring, m, k, n, seed):
    rng = np.random.default_rng(seed)
    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    qs = ring.q.reshape(L, 1, 1, 1)
    a = rng.integers(0, 1 << 62, (L, S, m, k), dtype=np.uint64) % qs
    b = rng.integers(0, 1 << 62, (L, S, k, n), dtype=np.uint64) % qs
    lhs_dig = tmm.digits(tu.u64_tensor(a), nd).reshape(L, S, m, k * nd)
    return lhs_dig, tmm.prescale_digits_band(tu.u64_tensor(b), ring)


@pytest.mark.parametrize("bound,vals,row_off,col_off", [
    (100, False, 0, 0), (100, True, 5, 3), (2000, False, 0, 7), (2000, True, 9, 0)])
def test_gen_noise_equals_pallas_interpret(bound, vals, row_off, col_off):
    """The port's ``gen_noise`` product against the interpret-mode Pallas
    kernel generating v3k in VMEM: value and digit noise rows, row and
    column offsets in the seeds."""
    tr, jring = TRing(TOY, 8), JRing(TOY, 8)
    L, l, nd = tr.num_limbs, tr.degree, tr.num_digits
    m, k, n = 8, 6, 4
    lhs_dig, band = digit_operands(tr, m, k, n, 40 + bound)
    jr = tntt.signed_digit_count(bound)
    seeds = np.array([*KEY, row_off, col_off], np.uint32).astype(np.int32)
    got = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig,
                                 gen_noise=(torch.from_numpy(seeds), jr, bound, "tfry"))
    tables = jnp.repeat(jnp.asarray(jpm._pack_tables(jring, nd)), l, axis=0)
    ntab = jnp.asarray(jring.ntt_scaled_tab(1 if vals else jr), jnp.int32).reshape(
        L * l, l * (1 if vals else jr), nd)
    oh, ol = jpm._fused_scaled_noise_matmul(
        jnp.asarray(lhs_dig.reshape(L * l, m, k * nd).numpy()),
        jnp.asarray(band.reshape(L * l, nd, k * nd, n).numpy()), tables, ntab,
        None, None, None, 8, 4, True, jring.fold_words_ok, False, jnp.asarray(seeds),
        (l, jr, bound, True), l if vals else 0, 0, False, False)
    want = ju.join_u64_np(np.asarray(oh), np.asarray(ol)).reshape(L, l, m, n)
    np.testing.assert_array_equal(tu.u64_numpy(got), want)


def test_gen_noise_equals_generated_planes():
    """``gen_noise`` is the product with the generator's planes as
    ``noise``: the seeds' words are (key0, key1, row_offset, col_offset)."""
    tr = TRing(generate_ntt_primes(61, 3, 16), 16)
    lhs_dig, band = digit_operands(tr, 5, 3, 6, 41)
    got = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig,
                                 gen_noise=((*KEY, 2, 11), 2, 300, "tfry"))
    planes = tfm.v3k_noise_planes(*KEY, 2, 5, 6, 16, 300, col_off=11, device="cpu")
    want = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig, noise=planes,
                                  noise_bound=300)
    assert torch.equal(got, want)


def encode_operands(ring, m, n, seed):
    """u64 scalars [m, n] (some >= 2^63) and a gadget table [L, l], as the
    port's (sc, etab) and the JAX package's (sc_hi, sc_lo, enc_tab)."""
    rng = np.random.default_rng(seed)
    L, l = ring.num_limbs, ring.degree
    sc = rng.integers(0, 1 << 63, (m, n), dtype=np.uint64) * np.uint64(2)
    sc[0, :2] = [1 << 63, (1 << 64) - 1]
    g = rng.integers(0, 1 << 62, (L, l), dtype=np.uint64) % ring.q[:, None]
    gs = np.array([[(int(g[i, s]) << 64) // q for s in range(l)]
                   for i, q in enumerate(ring.moduli)], object)
    gs = (gs & 0xFFFFFFFFFFFFFFFF).astype(np.uint64)
    wrap = np.array([[pow(2, 64, q) * int(g[i, s]) % q for s in range(l)]
                     for i, q in enumerate(ring.moduli)], np.uint64)
    hi, lo = ju.split_u64_np(sc)
    return ((tu.u64_tensor(sc), tu.u64_tensor(tfm.encode_tab(g, gs, wrap))),
            (jnp.asarray(hi), jnp.asarray(lo),
             jnp.asarray(jpm.encode_tab(g, gs, wrap, ring.moduli))))


def jax_kernel1(jring, lhs_dig, band, jr, vals, noise=None, post=None, encode=None,
                seeds=None, gen=None, masked=False):
    """Interpret-mode ``_fused_scaled_noise_matmul`` on the port's operands
    (8 x 4 tiles) -> uint64 [L, l, m, n]."""
    L, l, m, kd = lhs_dig.shape
    nd, n = band.shape[2], band.shape[4]
    tables = jnp.repeat(jnp.asarray(jpm._pack_tables(jring, nd)), l, axis=0)
    if jr:
        ntab = jnp.asarray(jring.ntt_scaled_tab(1 if vals else jr), jnp.int32).reshape(
            L * l, l * (1 if vals else jr), nd)
    else:                       # post alone: a zero noise plane, as the JAX entry does
        noise, ntab = jnp.zeros((1, m, n), jnp.int8), jnp.zeros((L * l, 1, nd), jnp.int32)
    oh, ol = jpm._fused_scaled_noise_matmul(
        jnp.asarray(lhs_dig.reshape(L * l, m, kd).numpy()),
        jnp.asarray(band.reshape(L * l, nd, kd, n).numpy()), tables, ntab, noise, post,
        encode, 8, 4, True, jring.fold_words_ok, False,
        None if seeds is None else jnp.asarray(seeds), gen,
        l if vals and jr else 0, jr if vals and noise is not None and jr else 0, False,
        masked)
    return ju.join_u64_np(np.asarray(oh), np.asarray(ol)).reshape(L, l, m, n)


@pytest.mark.parametrize("bound,vals,row_off,lo,hi,col_off", [
    (100, False, 0, 0, 5, 0), (100, True, 0, 5, 16, 3), (2000, False, 8, 10, 13, 7),
    (2000, True, 3, 0, 0, 0), (100, False, 0, 0, 16, 11), (100, True, 5, 3, 9, 0),
    (100, False, (1 << 32) - 4, (1 << 32) - 2, 5, 0)])
def test_masked_gen_noise_equals_pallas_interpret(bound, vals, row_off, lo, hi, col_off):
    """The masked form (6-word seeds: row offset, [lo, hi), column offset
    in word 5) with the encode against the interpret-mode Pallas kernel's
    ``masked=True`` with in-kernel v3k, over two row tiles: ragged, empty,
    full, off-tile ranges, a range inside the second tile, and rows that
    wrap past 2^32 (int32 -4.., the range [-2, 5))."""
    tr, jring = TRing(TOY, 8), JRing(TOY, 8)
    m, k, n = 16, 5, 4
    lhs_dig, band = digit_operands(tr, m, k, n, 60 + lo + hi)
    jr = tntt.signed_digit_count(bound)
    seeds = np.array([*KEY, row_off, lo, hi, col_off], np.uint32).astype(np.int32)
    enc, jenc = encode_operands(tr, m, n, 61)
    got = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig, encode=enc,
                                 gen_noise=(torch.from_numpy(seeds), jr, bound, "tfry"))
    want = jax_kernel1(jring, lhs_dig, band, jr, vals, encode=jenc, seeds=seeds,
                       gen=(8, jr, bound, True), masked=True)
    np.testing.assert_array_equal(tu.u64_numpy(got), want)


@pytest.mark.parametrize("bound,lo,hi", [(100, 5, 16), (2000, 0, 0)])
def test_masked_post_equals_pallas_interpret(bound, lo, hi):
    """The masked form with ``post=``: post on every row, the noise and the
    encode on [lo, hi) only, against the interpret-mode Pallas kernel's
    ``masked=True`` with a ``post`` input."""
    tr, jring = TRing(TOY, 8), JRing(TOY, 8)
    m, k, n = 16, 5, 4
    lhs_dig, band = digit_operands(tr, m, k, n, 67 + lo)
    jr = tntt.signed_digit_count(bound)
    seeds = np.array([*KEY, 2, lo, hi, 3], np.uint32).astype(np.int32)
    enc, jenc = encode_operands(tr, m, n, 68)
    rng = np.random.default_rng(69)
    post = rng.integers(0, 1 << 62, (2, 8, m, n), dtype=np.uint64) % tr.q.reshape(2, 1, 1, 1)
    got = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig, encode=enc,
                                 gen_noise=(torch.from_numpy(seeds), jr, bound, "tfry"),
                                 post=tu.u64_tensor(post))
    ph, pl = ju.split_u64_np(post.reshape(16, m, n))
    want = jax_kernel1(jring, lhs_dig, band, jr, False, post=(jnp.asarray(ph), jnp.asarray(pl)),
                       encode=jenc, seeds=seeds, gen=(8, jr, bound, True), masked=True)
    np.testing.assert_array_equal(tu.u64_numpy(got), want)


def test_masked_halves_sum_to_the_unmasked_product():
    """Complementary masked ranges hold each row's noise and encode once:
    masked [0, 7) + masked [7, 16) = unmasked + bare, mod q; the masked
    planes are the unmasked ones with the rows outside zeroed."""
    tr = TRing(generate_ntt_primes(61, 2, 16), 16)
    m, k, n = 16, 3, 5
    lhs_dig, band = digit_operands(tr, m, k, n, 62)
    enc, _ = encode_operands(tr, m, n, 63)
    q = tr.table("q", "cpu").reshape(-1, 1, 1, 1)

    def run(*mask):
        return tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig, encode=enc,
                                      gen_noise=((*KEY, 40, *mask, 9), 2, 700, "tfry"))

    halves = tu.addmod(run(40, 47), run(47, 56), q)
    whole = tu.addmod(run(), tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig), q)
    assert torch.equal(halves, whole)
    planes = tfm.v3k_noise_planes(*KEY, 40, m, n, 16, 700, 9, "cpu", mask=(44, 50))
    full = tfm.v3k_noise_planes(*KEY, 40, m, n, 16, 700, 9, "cpu")
    assert torch.equal(planes[:, 4:10], full[:, 4:10])
    assert not planes[:, :4].any() and not planes[:, 10:].any()


@pytest.mark.parametrize("jr,encode", [(0, False), (1, False), (2, True)])
def test_post_equals_pallas_interpret(jr, encode):
    """``post=`` (canonical residues added after the fold) alone, with noise
    planes and with the encode, against the interpret-mode Pallas kernel's
    ``post`` input."""
    tr, jring = TRing(TOY, 8), JRing(TOY, 8)
    m, k, n = 8, 6, 4
    lhs_dig, band = digit_operands(tr, m, k, n, 64 + jr)
    rng = np.random.default_rng(65)
    post = rng.integers(0, 1 << 62, (2, 8, m, n), dtype=np.uint64) % tr.q.reshape(2, 1, 1, 1)
    noise = bound = None
    if jr:
        bound = 50 if jr == 1 else 2000
        ev = rng.integers(-bound, bound + 1, (m, n, 8)).astype(np.int32)
        noise = tntt._digit_planes(torch.from_numpy(ev), jr)
    enc, jenc = encode_operands(tr, m, n, 66) if encode else (None, None)
    got = tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig, noise=noise, encode=enc,
                                 noise_bound=bound, post=tu.u64_tensor(post))
    ph, pl = ju.split_u64_np(post.reshape(16, m, n))
    want = jax_kernel1(jring, lhs_dig, band, jr, False,
                       noise=None if noise is None else jnp.asarray(noise.numpy()),
                       post=(jnp.asarray(ph), jnp.asarray(pl)), encode=jenc)
    np.testing.assert_array_equal(tu.u64_numpy(got), want)


def test_v4_and_bad_gen_noise_raise():
    tr = TRing(TOY, 8)
    lhs_dig, band = digit_operands(tr, 4, 2, 4, 42)
    with pytest.raises(NotImplementedError, match="TPU hardware PRNG"):
        tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig,
                               gen_noise=((*KEY, 0, 0), 1, 50))
    with pytest.raises(ValueError, match="5 words"):
        tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig,
                               gen_noise=((*KEY, 0, 4, 0), 1, 50, "tfry"))
    with pytest.raises(ValueError, match="mutually exclusive"):
        tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig,
                               noise=torch.zeros((8, 4, 4), dtype=torch.int8),
                               gen_noise=((*KEY, 0, 0), 1, 50, "tfry"))
    with pytest.raises(ValueError, match="no signed digits"):
        tfm.v3k_noise_planes(*KEY, 0, 4, 4, 8, 40000)


@pytest.mark.parametrize("bound,tfry,device,want", [
    (100, True, "cpu", True), (100, True, "cuda", True), (32639, True, "cpu", True),
    (40000, True, "cpu", False), (100, False, "cpu", False), (100, False, "cuda", False),
    (100, True, "meta", False)])
def test_kernel_noise_available(bound, tfry, device, want):
    """v3k with signed digits on the card or the CPU; v4 (no ``tfry``) on
    no device; bounds above the signed-digit range never."""
    assert tfm.kernel_noise_available(bound, tfry=tfry, device=device) is want


@pytest.mark.parametrize("stream", ["kernel", "v4", "v3", "v3k", "bogus"])
def test_stream_routing_matches_jax(stream, monkeypatch):
    """``kernel_noise_stream`` names the JAX package's stream; v3k takes
    ``gen_noise`` for both products (its planes made ahead of the fused
    matmul), every other stream draws v3 planes."""
    gpk = _system(P.PvwParameters(3, 4, 8, TOY, 0.5, 50, 2000))
    calls, v3, gens = [], [], []
    real_mm, real_v3, real_gen = (tenc.matmul_fold_scaled, tntt.noise_digit_planes,
                                  tenc.gen_noise_planes)
    monkeypatch.setattr(tenc, "matmul_fold_scaled",
                        lambda *a, **kws: calls.append(kws) or real_mm(*a, **kws))
    monkeypatch.setattr(tenc, "gen_noise_planes",
                        lambda g, *a: gens.append(g) or real_gen(g, *a))
    monkeypatch.setattr(tntt, "noise_digit_planes",
                        lambda *a, **kws: v3.append(a) or real_v3(*a, **kws))
    try:
        jsettings.noise_stream = tsettings.noise_stream = stream
        with warnings.catch_warnings(record=True) as warned:
            warnings.simplefilter("always")
            assert tsettings.kernel_noise_stream() == jsettings.kernel_noise_stream()
            P.encrypt_batch(np.ones((2, 3), np.uint64), gpk, R.key(3))
    finally:
        del jsettings.noise_stream, tsettings.noise_stream
    assert bool(warned) == (stream == "bogus")
    assert len(calls) == 2
    assert all(c.get("gen_noise") is None and c["noise"] is not None for c in calls)
    if stream == "v3k":
        assert [g[1:] for g in gens] == [(1, 50, "tfry"), (2, 2000, "tfry")]
        assert [c["noise_bound"] for c in calls] == [50, 2000] and v3 == []
    else:
        assert gens == [] and len(v3) == 2


def _system(p):
    crs = P.PvwCrs.new(p, R.key(1), device="cpu")
    parties = [P.Party.new(i, p, R.fold_in(R.key(2), i), device="cpu") for i in range(p.n)]
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, R.key(3))
    return gpk


@pytest.mark.parametrize("chain", ["toy", "config4"])
def test_v3k_encryption_equals_jax(chain, monkeypatch):
    """A v3k encryption through ``encrypt_all_party_shares_batched`` equals
    ``pvw_tpu``'s, on the toy chain and on a config-4-shaped chain (17 x
    61-bit, l = 16, nd = 8) at tiny n and k, both products through the
    generator; the shares decrypt exactly."""
    moduli, l, n, k = (TOY, 8, 5, 8) if chain == "toy" else \
        (generate_ntt_primes(61, 17, 16), 16, 3, 4)
    jp = (J.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
          .set_moduli(moduli).set_secret_variance(0.5).set_error_bounds_u32(50, 50).build())
    tp = convert.params_from_dict(jp.to_dict())
    jkey = jax.random.key(17)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(jkey, 1))
    jparties = [J.Party.new(i, jp, jax.random.fold_in(jkey, 10 + i)) for i in range(n)]
    jgpk = J.GlobalPublicKey(jcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(jkey, 2))
    tgpk = convert.global_pk_from_residues(
        jgpk.matrix.residues_np(),
        convert.crs_from_residues(jcrs.matrix.residues_np(), tp, device="cpu"))
    shares = np.random.default_rng(43).integers(0, 1 << 32, size=(n, n), dtype=np.uint64)
    key = jax.random.fold_in(jkey, 3)
    drawn = []
    real = tfm.v3k_noise_planes
    monkeypatch.setattr(tfm, "v3k_noise_planes",
                        lambda *a, **kws: drawn.append(a[3]) or real(*a, **kws))
    try:
        jsettings.noise_stream = tsettings.noise_stream = "v3k"
        jct = J.encrypt_all_party_shares_batched(shares, jgpk, key)
        tct = P.encrypt_all_party_shares_batched(shares, tgpk, kw(key))
    finally:
        del jsettings.noise_stream, tsettings.noise_stream
    assert drawn == [k, n]                       # c1 then c2, each generated once
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
    sk = convert.secret_key_from_coeffs(jparties[n - 1].secret_key.secret_coeffs, tp)
    assert P.decrypt_party_shares(tct, sk, n - 1) == [int(v) for v in shares[:, n - 1]]
