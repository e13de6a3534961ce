"""The swapped operand form of the port against the JAX package, on the CPU.

``lhs_scaled_planes`` and ``rhs_digit_cols`` are held against
``pvw_tpu.ops.modmat``; ``matmul_fold_swapped`` (its plain twin on the CPU)
against the Pallas kernel's ``swapped`` variant in interpret mode, as
``tests/test_swapped.py`` runs it; ``encrypt_batch`` with
``swapped_form`` on (d = 128 dealers, the route's least batch) against the
JAX package's ciphertexts, which it computes by the banded route on the
CPU. Residues and ciphertexts: exact equality. The CUDA kernel is held
against its twin in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import pvw_tpu as J
from pvw_tpu.config import settings as jsettings
from pvw_tpu.ops import modmat as jmm
from pvw_tpu.ops import pallas_modmat as jpm
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.ring import RingPlan as JRing
import pvw_tpu_torch as P
from pvw_tpu_torch import convert
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.crypto import decryption as tdec
from pvw_tpu_torch.crypto import encryption as tenc
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import modmat as tmm
from pvw_tpu_torch.ops import ntt as tntt
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import RingPlan as TRing

CHAINS = [((0xFFFFC4001, 0x1FFFFE0001), 5),                  # 37-bit, nd = 5
          ((0x80000000080001, 0x80000000130001), 8)]         # 55-bit, nd = 8
TOY = CHAINS[0][0]


def rand_u64(rng, shape):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=shape, dtype=np.uint64)


def encode_tables(rng, moduli, S):
    """(g, its 64-bit Shoup companion, (2^64 mod q)*g mod q), uint64 [L, S]."""
    q = np.array(moduli, np.uint64)[:, None]
    g = rand_u64(rng, (len(moduli), S)) % q
    gs = np.array([[(int(g[i, s]) << 64) // m for s in range(S)]
                   for i, m in enumerate(moduli)], object)
    wrap = np.array([[pow(2, 64, m) * int(g[i, s]) % m for s in range(S)]
                     for i, m in enumerate(moduli)], np.uint64)
    return g, (gs & 0xFFFFFFFFFFFFFFFF).astype(np.uint64), wrap


@pytest.mark.parametrize("moduli,nd", CHAINS)
def test_scaled_planes_and_digit_cols_equal_jax(moduli, nd):
    """The cached swapped lhs and the per-encryption rhs, byte for byte."""
    tr, jring = TRing(moduli, 8), JRing(moduli, 8)
    assert tr.num_digits == nd
    L, l, m, k, d = tr.num_limbs, 8, 5, 7, 9
    rng = np.random.default_rng(11)
    a = rand_u64(rng, (m, k, L, l)) % tr.q.reshape(1, 1, L, 1)
    r = rand_u64(rng, (L, l, k, d)) % tr.q.reshape(L, 1, 1, 1)
    got_a = tmm.lhs_scaled_planes(tu.u64_tensor(a), tr)
    want_a = jmm.lhs_scaled_planes(*map(jnp.asarray, ju.split_u64_np(a)), jring)
    assert got_a.dtype == torch.int8 and tuple(got_a.shape) == (L, l, nd, m, k * nd)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    got_r = tmm.rhs_digit_cols(tu.u64_tensor(r), tr)
    want_r = jmm.rhs_digit_cols(tuple(map(jnp.asarray, ju.split_u64_np(r))), jring)
    assert got_r.dtype == torch.int8 and tuple(got_r.shape) == (L, l, k * nd, d)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


@pytest.mark.parametrize("moduli,nd", CHAINS)
@pytest.mark.parametrize("mode", ["bare", "noise", "enc32", "enc64"])
def test_swapped_twin_equals_pallas_interpret(moduli, nd, mode):
    """``matmul_fold_swapped`` on the CPU against the interpret-mode Pallas
    kernel's swapped variant at ``tests/test_swapped.py``'s shapes: bare,
    with noise planes (bound 100), and with the 32- and 64-bit encodes
    (scalars 0, 2^63 and 2^64 - 1 among them) on top of the noise."""
    tr, jring = TRing(moduli, 8), JRing(moduli, 8)
    L, l, m, k, d = tr.num_limbs, 8, 16, 8, 128
    rng = np.random.default_rng(3)
    a = rand_u64(rng, (m, k, L, l)) % tr.q.reshape(1, 1, L, 1)
    r = rand_u64(rng, (L, l, k, d)) % tr.q.reshape(L, 1, 1, 1)
    planes = tmm.lhs_scaled_planes(tu.u64_tensor(a), tr)
    rd = tmm.rhs_digit_cols(tu.u64_tensor(r), tr)
    noise = bound = None
    tenc_, jenc = None, None
    if mode != "bare":
        bound = 100
        noise = rng.integers(-bound, bound + 1, (l, m, d)).astype(np.int8)
    if mode.startswith("enc"):
        sc = rand_u64(rng, (m, d))
        sc[0, :3] = [0, 1 << 63, (1 << 64) - 1]
        if mode == "enc32":
            sc &= np.uint64(0xFFFFFFFF)
        gtabs = encode_tables(rng, moduli, l)
        tenc_ = (tu.u64_tensor(sc), tu.u64_tensor(tfm.encode_tab(*gtabs)))
        jenc = (*map(jnp.asarray, ju.split_u64_np(sc)),
                jnp.asarray(jpm.encode_tab(*gtabs, moduli)))
    got = tfm.matmul_fold_swapped(planes, rd, tr,
                                  noise=None if noise is None else torch.from_numpy(noise),
                                  encode=tenc_, encode32=mode == "enc32", noise_bound=bound)
    wh, wl = jpm.matmul_fold_swapped(
        jnp.asarray(planes.numpy()), jnp.asarray(rd.numpy()), jring,
        noise=None if noise is None else jnp.asarray(noise), encode=jenc,
        encode32=mode == "enc32", noise_bound=bound, interpret=True)
    np.testing.assert_array_equal(tu.u64_numpy(got), ju.join_u64_np(np.asarray(wh),
                                                                    np.asarray(wl)))


def test_swapped_equals_banded_twin_with_generated_noise():
    """``gen_noise`` on the swapped form is the generator's planes added as
    ``noise``; the result is the banded product's."""
    tr = TRing(CHAINS[1][0], 8)
    L, l, m, k, d = tr.num_limbs, 8, 6, 5, 7
    rng = np.random.default_rng(4)
    a = tu.u64_tensor(rand_u64(rng, (m, k, L, l)) % tr.q.reshape(1, 1, L, 1))
    r = tu.u64_tensor(rand_u64(rng, (L, l, k, d)) % tr.q.reshape(L, 1, 1, 1))
    gen = ((0xDEADBEEF, 0x12345678, 3, 9), 2, 2000, "tfry")
    got = tfm.matmul_fold_swapped(tmm.lhs_scaled_planes(a, tr), tmm.rhs_digit_cols(r, tr),
                                  tr, gen_noise=gen)
    want = tfm.matmul_fold_scaled(None, tmm.prescale_digits_band(r, tr), tr,
                                  lhs_dig=tmm.lhs_digit_planes(a, tr), gen_noise=gen)
    assert torch.equal(got, want)


def test_swapped_guards():
    tr = TRing(TOY, 8)
    planes = torch.zeros((2, 8, 5, 4, 15), dtype=torch.int8)
    rd = torch.zeros((2, 8, 15, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.matmul_fold_swapped(planes.to("meta"), rd.to("meta"), tr)
    with pytest.raises(ValueError, match="does not match"):
        tfm.matmul_fold_swapped(planes[:, :, :4], rd, tr)
    with pytest.raises(ValueError, match="mutually exclusive"):
        tfm.matmul_fold_swapped(planes, rd, tr, noise=torch.zeros((8, 4, 3), dtype=torch.int8),
                                gen_noise=((1, 2, 0, 0), 1, 50, "tfry"))


def params_pair(moduli=TOY, b2=2000):
    jp = (J.PvwParametersBuilder().set_parties(8).set_dimension(8).set_l(8)
          .set_moduli(moduli).set_secret_variance(0.5).set_error_bounds_u32(50, b2).build())
    return jp, convert.params_from_dict(jp.to_dict())


@pytest.mark.parametrize("d,b1,b2,on,want", [
    (128, 50, 2000, True, True), (4096, 50, 32639, True, True), (128, 50, 2000, False, False),
    (127, 50, 2000, True, False), (128, 50, 40000, True, False), (128, 40000, 50, True, False),
    (128, 50, 0xFFFFC4001, True, False)])
def test_swapped_form_ok(d, b1, b2, on, want):
    """Off by default; on, it needs d >= 128 and both bounds with signed
    digits: a bound above 32639 (residue noise) or at least the smallest
    modulus (host noise) keeps the banded form."""
    p = P.PvwParameters(8, 8, 8, TOY, 0.5, b1, b2)
    assert tenc._swapped_form_ok(p, d) is False
    tsettings.swapped_form = on
    try:
        assert tenc._swapped_form_ok(p, d) is want
    finally:
        del tsettings.swapped_form


@pytest.mark.parametrize("raw", ["1", "true", "0", "off", ""])
def test_swapped_knob_parses_as_jax(raw, monkeypatch):
    monkeypatch.setenv("PVW_TPU_SWAPPED", raw)
    assert tsettings.swapped_form is jsettings.swapped_form
    assert tsettings.swapped_form is (raw in ("1", "true"))


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


@pytest.fixture(scope="module")
def toy_system():
    """One key set in both packages (n = k = l = 8, bounds (50, 2000)) and
    the JAX ciphertexts of 128 dealers under v3 and v3k."""
    jp, tp = params_pair()
    jkey = jax.random.key(31)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(jkey, 1))
    jparties = [J.Party.new(i, jp, jax.random.fold_in(jkey, 10 + i)) for i in range(8)]
    jgpk = J.GlobalPublicKey(jcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(jkey, 2))
    tgpk = convert.global_pk_from_residues(
        jgpk.matrix.residues_np(),
        convert.crs_from_residues(jcrs.matrix.residues_np(), tp, device="cpu"))
    rng = np.random.default_rng(32)
    scalars = {"v3": rng.integers(0, 1 << 32, (128, 8), dtype=np.uint64),
               "v3k": rng.integers(0, 1 << 40, (128, 8), dtype=np.uint64)}
    key = jax.random.fold_in(jkey, 3)
    cts = {}
    for stream, sc in scalars.items():
        jsettings.noise_stream = stream
        try:
            jct = J.encrypt_batch(sc, jgpk, key)
        finally:
            del jsettings.noise_stream
        cts[stream] = (jct.c1.residues_np(), jct.c2.residues_np())
    sks = [convert.secret_key_from_coeffs(p.secret_key.secret_coeffs, tp) for p in jparties]
    return tp, tgpk, sks, scalars, kw(key), cts


def shares_of(ct, sk, party: int) -> list[int]:
    """``party``'s share from every dealer column of a batched ciphertext."""
    p = ct.params
    z = tdec._noisy_messages(p, sk.to_polynomials("cpu").res, ct.c1.channel(),
                             ct.c2.channel()[:, :, party])
    return tdec._decode_batch(z, p)


@pytest.mark.parametrize("stream", ["v3", "v3k"])
def test_swapped_encryption_equals_jax(stream, toy_system, monkeypatch):
    """``encrypt_batch`` with ``swapped_form`` on takes the swapped route
    for both products (the scaled key planes, the plain digits of r) and
    gives the JAX package's ciphertexts byte for byte; every share of
    parties 0 and 7 decrypts exactly (64-bit scalars under v3k)."""
    tp, tgpk, sks, scalars, key, cts = toy_system
    calls = []
    real = tenc.matmul_fold_swapped
    monkeypatch.setattr(tenc, "matmul_fold_swapped",
                        lambda *a, **kws: calls.append(a[0].shape) or real(*a, **kws))
    tsettings.noise_stream = stream
    tsettings.swapped_form = True
    try:
        ct = P.encrypt_batch(scalars[stream], tgpk, key)
    finally:
        del tsettings.noise_stream, tsettings.swapped_form
    assert calls == [(2, 8, 5, 8, 40), (2, 8, 5, 8, 40)]          # c1 (k = 8), c2 (n = 8)
    np.testing.assert_array_equal(ct.c1.residues_np(), cts[stream][0])
    np.testing.assert_array_equal(ct.c2.residues_np(), cts[stream][1])
    for party in (0, 7):
        assert shares_of(ct, sks[party], party) == [int(v) for v in scalars[stream][:, party]]


def test_swapped_operands_cached(toy_system):
    """``encrypt_operands_swapped`` is cached like ``encrypt_operands``, in
    the same single slot (asking for one form drops the other), and remade
    when the key matrix changes."""
    _, tgpk, _, _, _, _ = toy_system
    first = tgpk.encrypt_operands_swapped()
    assert tgpk.encrypt_operands_swapped() is first
    assert tuple(first[1].shape) == (2, 8, 5, 8, 40)
    plain = tgpk.encrypt_operands()
    assert plain is tgpk.encrypt_operands() and tuple(plain[1].shape) == (2, 8, 8, 40)
    remade = tgpk.encrypt_operands_swapped()                # the banded set replaced it
    assert remade is not first and torch.equal(remade[1], first[1])
    first = remade
    old = tgpk.matrix
    tgpk.matrix = P.Poly(old.res.clone(), old.rep, old.ring)
    try:
        again = tgpk.encrypt_operands_swapped()
        assert again is not first and torch.equal(again[1], first[1])
    finally:
        tgpk.matrix = old
