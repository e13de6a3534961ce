"""The fused scaled-digit matmul of the port against the JAX package.

The plain twin ``matmul_fold_scaled_plain`` (what the wrapper runs for CPU
tensors) is held against ``pvw_tpu.ops.pallas_modmat.matmul_fold_scaled``
(its XLA route off the TPU) and against the Pallas kernel
``_fused_scaled_noise_matmul`` in interpret mode, on the same digit
tensors. Residues: exact equality. The CUDA kernel is held against the
twin in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pvw_tpu.config import settings as jsettings
from pvw_tpu.ops import pallas_modmat as jpm
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.ring import RingPlan as JRing
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import modmat as tmm
from pvw_tpu_torch.ops import ntt as tntt
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import RingPlan as TRing

TOY = (0xFFFFC4001, 0x1FFFFE0001)
BIG = (0x800000022A0001, 0x800000021A0001)


def rand_u64(rng, shape):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=shape, dtype=np.uint64)


def operands(moduli, jr, encode, seed, m=8, k=6, n=4):
    """Digit operands, noise planes and encode inputs as numpy."""
    rng = np.random.default_rng(seed)
    tr = TRing(moduli, 8)
    L, S, nd = tr.num_limbs, 8, tr.num_digits
    qs = tr.q.reshape(L, 1, 1, 1)
    a = rand_u64(rng, (L, S, m, k)) % qs
    b = rand_u64(rng, (L, S, k, n)) % qs
    lhs_dig = tmm.digits(tu.u64_tensor(a), nd).reshape(L, S, m, k * nd).numpy()
    band = tmm.prescale_digits_band(tu.u64_tensor(b), tr).numpy()
    bound = 50 if jr == 1 else 2000
    ev = rng.integers(-bound, bound + 1, (m, n, 8)).astype(np.int32)
    planes = tntt._digit_planes(torch.from_numpy(ev), jr).numpy()
    sc = rand_u64(rng, (m, n))
    sc[0, 0], sc[1, 0], sc[2, 0] = 0, 1 << 63, (1 << 64) - 1
    if encode == "enc32":
        sc &= np.uint64(0xFFFFFFFF)
    g = rand_u64(rng, (L, S)) % tr.q[:, None]
    gs = np.array([[(int(g[i, s]) << 64) // q for s in range(S)]
                   for i, q in enumerate(moduli)], object)
    gs = (gs & 0xFFFFFFFFFFFFFFFF).astype(np.uint64)
    wrap = np.array([[pow(2, 64, q) * int(g[i, s]) % q for s in range(S)]
                     for i, q in enumerate(moduli)], np.uint64)
    return tr, lhs_dig, band, planes, bound, sc, (g, gs, wrap)


def port_run(tr, lhs_dig, band, planes, bound, sc, gtabs, encode):
    enc = None
    if encode:
        enc = (tu.u64_tensor(sc), tu.u64_tensor(tfm.encode_tab(*gtabs)))
    return tu.u64_numpy(tfm.matmul_fold_scaled(
        None, torch.from_numpy(band), tr, noise=torch.from_numpy(planes), encode=enc,
        lhs_dig=torch.from_numpy(lhs_dig), encode32=encode == "enc32",
        noise_bound=bound))


CASES = [(TOY, 1, None), (TOY, 2, "enc64"), (BIG, 1, "enc32"), (BIG, 2, "enc64")]


@pytest.mark.parametrize("moduli,jr,encode", CASES)
def test_plain_twin_equals_jax_xla_route(moduli, jr, encode):
    tr, lhs_dig, band, planes, bound, sc, gtabs = operands(moduli, jr, encode, 21)
    got = port_run(tr, lhs_dig, band, planes, bound, sc, gtabs, encode)
    jring = JRing(moduli, 8)
    enc = None
    if encode:
        enc = (*map(jnp.asarray, ju.split_u64_np(sc)),
               jnp.asarray(jpm.encode_tab(*gtabs, moduli)))
    wh, wl = jpm.matmul_fold_scaled(None, jnp.asarray(band), jring,
                                    noise=jnp.asarray(planes), encode=enc,
                                    lhs_dig=jnp.asarray(lhs_dig),
                                    encode32=encode == "enc32", noise_bound=bound)
    np.testing.assert_array_equal(got, ju.join_u64_np(np.asarray(wh), np.asarray(wl)))
    # and against Python ints: the residues are < q
    assert np.all(got < tr.q.reshape(-1, 1, 1, 1))


@pytest.mark.parametrize("moduli,jr,encode", CASES)
@pytest.mark.parametrize("vals", [False, True])
def test_plain_twin_equals_pallas_interpret(moduli, jr, encode, vals):
    tr, lhs_dig, band, planes, bound, sc, gtabs = operands(moduli, jr, encode, 22)
    got = port_run(tr, lhs_dig, band, planes, bound, sc, gtabs, encode)
    jring = JRing(moduli, 8)
    L, S, nd = tr.num_limbs, 8, tr.num_digits
    m, kd, n = lhs_dig.shape[2], lhs_dig.shape[3], band.shape[4]
    tables = jnp.repeat(jnp.asarray(jpm._pack_tables(jring, nd)), S, axis=0)
    ntab = jnp.asarray(jring.ntt_scaled_tab(1 if vals else jr), jnp.int32
                       ).reshape(L * S, 8 * (1 if vals else jr), nd)
    enc = None
    if encode:
        enc = (*map(jnp.asarray, ju.split_u64_np(sc)),
               jnp.asarray(jpm.encode_tab(*gtabs, moduli)))
    oh, ol = jpm._fused_scaled_noise_matmul(
        jnp.asarray(lhs_dig.reshape(L * S, m, kd)),
        jnp.asarray(band.reshape(L * S, nd, kd, n)), tables, ntab,
        jnp.asarray(planes), None, enc, 8, 4, True, jring.fold_words_ok,
        encode == "enc32", None, None, 8 if vals else 0, jr if vals else 0)
    want = ju.join_u64_np(np.asarray(oh), np.asarray(ol)).reshape(L, S, m, n)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("moduli", [TOY, BIG])
def test_kernel_tables_equal_jax(moduli):
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    nd = tr.num_digits
    t, j = tfm.pack_tables(tr, nd), jpm._pack_tables(jr, nd)
    np.testing.assert_array_equal(t[:, 0], ju.join_u64_np(j[:, 18], j[:, 19]))
    np.testing.assert_array_equal(t[:, 1], ju.join_u64_np(j[:, 16], j[:, 17]))
    for g in (0, 1):
        np.testing.assert_array_equal(t[:, 2 + 2 * g], ju.join_u64_np(j[:, g], j[:, 4 + g]))
        np.testing.assert_array_equal(t[:, 3 + 2 * g],
                                      ju.join_u64_np(j[:, 8 + g], j[:, 12 + g]))
    _, _, _, _, _, _, gtabs = operands(moduli, 1, "enc64", 23)
    te, je = tfm.encode_tab(*gtabs), jpm.encode_tab(*gtabs, moduli)
    for c in range(3):
        np.testing.assert_array_equal(te[:, c], ju.join_u64_np(je[:, 2 * c], je[:, 2 * c + 1]))


@pytest.mark.parametrize("k,jr,bound", [(6, 1, 50), (256, 1, 50), (8192, 2, None),
                                        (1024, 2, 32639)])
@pytest.mark.parametrize("knob", [True, False])
def test_noise_value_mode_matches_jax(k, jr, bound, knob):
    tr, jr_ = TRing(BIG, 8), JRing(BIG, 8)
    try:
        jsettings.noise_value_mac = knob
        tsettings.noise_value_mac = knob
        assert tfm._noise_vals_mode(tr, k, jr, bound) == jpm._noise_vals_mode(jr_, k, jr, bound)
    finally:
        del jsettings.noise_value_mac
        del tsettings.noise_value_mac


def test_wrapper_routes_by_device_and_rejects_the_unported():
    tr, lhs_dig, band, planes, bound, sc, gtabs = operands(TOY, 1, None, 24)
    ld, bd, nz = map(torch.from_numpy, (lhs_dig, band, planes))
    got = tfm.matmul_fold_scaled(None, bd, tr, noise=nz, lhs_dig=ld)
    assert torch.equal(got, tfm.matmul_fold_scaled_plain(None, bd, tr, noise=nz, lhs_dig=ld))
    with pytest.raises(NotImplementedError, match="gen_noise"):
        tfm.matmul_fold_scaled(None, bd, tr, lhs_dig=ld, gen_noise=(None, 1, 50))
    with pytest.raises(ValueError, match="different devices"):
        tfm.matmul_fold_scaled(None, bd, tr, noise=nz.to("meta"), lhs_dig=ld)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.matmul_fold_scaled(None, bd.to("meta"), tr, lhs_dig=ld.to("meta"))
    with pytest.raises(ValueError, match="l\\*jr rows"):
        tfm.matmul_fold_scaled(None, bd, tr, noise=nz[:5], lhs_dig=ld)
