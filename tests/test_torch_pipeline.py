"""The pipelined route of the port against the JAX package, on the CPU.

With ``pipeline_fold`` on, ``matmul_fold_scaled`` launches the pipelined
kernel for CUDA operands; on the CPU it takes the plain twin, which is the
same function. That route is held against the Pallas kernel
``_fused_pipelined_matmul`` in interpret mode at ``tests/test_pipeline.py``'s
shapes: input noise planes, in-kernel v3k with both encodes, and the
value-row modes. Whole encryptions with the setting on are held against
the JAX package's ciphertexts. Residues and ciphertexts: exact equality.
The CUDA kernel is held against its twin in ``tests/test_torch_cuda.py``.
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
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import modmat as tmm
from pvw_tpu_torch.ops import ntt as tntt
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import RingPlan as TRing

MODULI = (0xFFFFC4001, 0x1FFFFE0001)
BIG_MODULI = (0x80000000080001, 0x80000000130001)
KEY = (0xDEADBEEF, 0x12345678)


def rand_u64(rng, shape):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=shape, dtype=np.uint64)


def setup(moduli, seed, m=16, k=6, n=8):
    """Port operands and the JAX kernel's: lhs digit planes, the band (from
    the JAX package's ``prescale_digits_band``, the layout
    ``matmul_fold_scaled`` gives its kernels) and the fold tables."""
    tr, jring = TRing(moduli, 8), JRing(moduli, 8)
    L, S, nd = tr.num_limbs, 8, tr.num_digits
    rng = np.random.default_rng(seed)
    qs = tr.q.reshape(L, 1, 1, 1)
    a = rand_u64(rng, (L, S, m, k)) % qs
    b = rand_u64(rng, (L, S, k, n)) % qs
    lhs_dig = tmm.digits(tu.u64_tensor(a), nd).reshape(L, S, m, k * nd)
    band = tmm.prescale_digits_band(tu.u64_tensor(b), tr)
    jband = jmm.prescale_digits_band(tuple(map(jnp.asarray, ju.split_u64_np(b))), jring)
    np.testing.assert_array_equal(band.numpy(), np.asarray(jband))
    tables = jnp.repeat(jnp.asarray(jpm._pack_tables(jring, nd)), S, axis=0)
    jops = (jnp.asarray(lhs_dig.reshape(L * S, m, k * nd).numpy()),
            jband.reshape(L * S, nd, k * nd, n), tables)
    return tr, jring, rng, lhs_dig, band, jops


def ntab(jring, jr: int):
    L, l, nd = jring.num_limbs, jring.degree, jring.num_digits
    return jnp.asarray(jring.ntt_scaled_tab(jr), jnp.int32).reshape(L * l, l * jr, nd)


def encode_pair(rng, moduli, m, n, encode32):
    """The port's and the JAX kernel's encode operands: scalars (0, 2^63,
    2^64 - 1 among them) and real (g, Shoup(g), wrap) tables."""
    sc = rand_u64(rng, (m, n))
    sc[0, :3] = [0, 1 << 63, (1 << 64) - 1]
    if encode32:
        sc &= np.uint64(0xFFFFFFFF)
    q = np.array(moduli, np.uint64)[:, None]
    g = rand_u64(rng, (len(moduli), 8)) % q
    gs = np.array([[(int(g[i, s]) << 64) // mq for s in range(8)]
                   for i, mq in enumerate(moduli)], object)
    gs = (gs & 0xFFFFFFFFFFFFFFFF).astype(np.uint64)
    wrap = np.array([[pow(2, 64, mq) * int(g[i, s]) % mq for s in range(8)]
                     for i, mq in enumerate(moduli)], np.uint64)
    return ((tu.u64_tensor(sc), tu.u64_tensor(tfm.encode_tab(g, gs, wrap))),
            (*map(jnp.asarray, ju.split_u64_np(sc)),
             jnp.asarray(jpm.encode_tab(g, gs, wrap, moduli))))


def pipelined(tr, lhs_dig, band, **kws):
    """The port's product with ``pipeline_fold`` on."""
    tsettings.pipeline_fold = True
    try:
        return tu.u64_numpy(tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig, **kws))
    finally:
        del tsettings.pipeline_fold


def joined(oh, ol, shape):
    return ju.join_u64_np(np.asarray(oh), np.asarray(ol)).reshape(shape)


@pytest.mark.parametrize("moduli", [MODULI, BIG_MODULI])
@pytest.mark.parametrize("bound", [100, 2000])
def test_input_planes_equal_pallas_pipelined(moduli, bound):
    """Input noise digit planes (digit rows, jr = 1 and 2), both chains."""
    tr, jring, rng, lhs_dig, band, jops = setup(moduli, 7)
    L, l, m, n = tr.num_limbs, 8, 16, 8
    jr = tntt.signed_digit_count(bound)
    ev = rng.integers(-bound, bound + 1, (m, n, l)).astype(np.int32)
    planes = tntt._digit_planes(torch.from_numpy(ev), jr)
    got = pipelined(tr, lhs_dig, band, noise=planes, noise_bound=bound)
    oh, ol = jpm._fused_pipelined_matmul(*jops, ntab(jring, jr), jnp.asarray(planes.numpy()),
                                         None, 8, 8, True, jring.fold_words_ok)
    np.testing.assert_array_equal(got, joined(oh, ol, (L, l, m, n)))


@pytest.mark.parametrize("encode32", [True, False])
def test_gen_tfry_encode_equal_pallas_pipelined(encode32):
    """In-kernel v3k generation (row and column offsets in the seeds) with
    the 32- and 64-bit encodes."""
    tr, jring, rng, lhs_dig, band, jops = setup(MODULI, 8)
    L, l, m, n, bound = tr.num_limbs, 8, 16, 8, 100
    jr = tntt.signed_digit_count(bound)
    seeds = np.array([*KEY, 5, 9], np.uint32).astype(np.int32)
    tenc, jenc = encode_pair(rng, MODULI, m, n, encode32)
    got = pipelined(tr, lhs_dig, band, encode=tenc, encode32=encode32,
                    gen_noise=(torch.from_numpy(seeds), jr, bound, "tfry"))
    oh, ol = jpm._fused_pipelined_matmul(*jops, ntab(jring, jr), None, jenc, 8, 8, True,
                                         jring.fold_words_ok, encode32, jnp.asarray(seeds),
                                         (l, jr, bound, True))
    np.testing.assert_array_equal(got, joined(oh, ol, (L, l, m, n)))


@pytest.mark.parametrize("bound,in_planes", [(100, False), (2000, True), (100, True),
                                             (2000, False)])
def test_value_rows_equal_pallas_pipelined(bound, in_planes):
    """The value-row MAC of the Pallas kernel (jr = 1 table, the planes
    composed into values): in-kernel v3k values and composed input planes."""
    tr, jring, rng, lhs_dig, band, jops = setup(MODULI, 21)
    L, l, m, n = tr.num_limbs, 8, 16, 8
    jr = tntt.signed_digit_count(bound)
    if in_planes:
        ev = rng.integers(-bound, bound + 1, (m, n, l)).astype(np.int32)
        planes = tntt._digit_planes(torch.from_numpy(ev), jr)
        got = pipelined(tr, lhs_dig, band, noise=planes, noise_bound=bound)
        args = (jnp.asarray(planes.numpy()), None, 8, 8, True, jring.fold_words_ok, False,
                None, None, l, jr)
    else:
        seeds = np.array([5, 11, 0, 0], np.int32)
        got = pipelined(tr, lhs_dig, band, gen_noise=(seeds, jr, bound, "tfry"))
        args = (None, None, 8, 8, True, jring.fold_words_ok, False, jnp.asarray(seeds),
                (l, jr, bound, True), l, 0)
    oh, ol = jpm._fused_pipelined_matmul(*jops, ntab(jring, 1), *args)
    np.testing.assert_array_equal(got, joined(oh, ol, (L, l, m, n)))


def test_pipeline_routing():
    """The pipelined kernel takes CUDA products with noise or an encode
    when the setting is on; bare products and CPU tensors do not, and a
    device that is neither raises."""
    assert not tfm.pipeline_takes("cuda")
    tsettings.pipeline_fold = True
    try:
        assert tfm.pipeline_takes("cuda") and tfm.pipeline_takes(torch.device("cuda", 0))
        assert not tfm.pipeline_takes("cuda", bare=True)
        assert not tfm.pipeline_takes("cpu")
        tr = TRing(MODULI, 8)
        lhs_dig = torch.zeros((2, 8, 4, 10), dtype=torch.int8, device="meta")
        band = torch.zeros((2, 8, 5, 10, 3), dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tfm.matmul_fold_scaled(None, band, tr, lhs_dig=lhs_dig,
                                   noise=torch.zeros((8, 4, 3), dtype=torch.int8,
                                                     device="meta"))
    finally:
        del tsettings.pipeline_fold


@pytest.mark.parametrize("raw", ["1", "yes", "0", "false", ""])
def test_pipeline_knob_parses_as_jax(raw, monkeypatch):
    monkeypatch.setenv("PVW_TPU_PIPELINE", raw)
    assert tsettings.pipeline_fold is jsettings.pipeline_fold
    assert tsettings.pipeline_fold is (raw in ("1", "yes"))


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


@pytest.mark.parametrize("stream", ["v3", "v3k"])
def test_pipelined_encryption_equals_jax(stream):
    """``encrypt_batch`` of 128 dealers with ``pipeline_fold`` on (the JAX
    package routes its banded kernel on the CPU, the port its twin) gives
    the same ciphertexts byte for byte; every share of parties 0 and 7
    decrypts exactly."""
    jp = (J.PvwParametersBuilder().set_parties(8).set_dimension(8).set_l(8)
          .set_moduli(MODULI).set_secret_variance(0.5).set_error_bounds_u32(50, 2000)
          .build())
    tp = convert.params_from_dict(jp.to_dict())
    jkey = jax.random.key(41)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(jkey, 1))
    jparties = [J.Party.new(i, jp, jax.random.fold_in(jkey, 10 + i)) for i in range(8)]
    jgpk = J.GlobalPublicKey(jcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(jkey, 2))
    tgpk = convert.global_pk_from_residues(
        jgpk.matrix.residues_np(),
        convert.crs_from_residues(jcrs.matrix.residues_np(), tp, device="cpu"))
    scalars = np.random.default_rng(42).integers(
        0, 1 << (32 if stream == "v3" else 40), (128, 8), dtype=np.uint64)
    key = jax.random.fold_in(jkey, 3)
    jsettings.noise_stream = tsettings.noise_stream = stream
    jsettings.pipeline_fold = tsettings.pipeline_fold = True
    try:
        jct = J.encrypt_batch(scalars, jgpk, key)
        tct = P.encrypt_batch(scalars, tgpk, kw(key))
    finally:
        del jsettings.noise_stream, tsettings.noise_stream
        del jsettings.pipeline_fold, tsettings.pipeline_fold
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
    for party in (0, 7):
        sk = convert.secret_key_from_coeffs(jparties[party].secret_key.secret_coeffs, tp)
        z = tdec._noisy_messages(tp, sk.to_polynomials("cpu").res, tct.c1.channel(),
                                 tct.c2.channel()[:, :, party])
        assert tdec._decode_batch(z, tp) == [int(v) for v in scalars[:, party]]
