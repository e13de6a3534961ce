"""The port's dealer-split, limb-parallel and grid backends against the JAX
package, on the CPU.

The companion of ``tests/test_torch_parallel.py`` (the (recv, kdim) mesh),
with the same systems: JAX on its 8 virtual CPU devices, the port's
backends on the CPU device repeated, the same CRS, key matrix and keys
(``convert.py``). Ciphertexts are compared byte for byte, decryptions
exactly (tolerance 0).
"""

import contextlib
import functools

import numpy as np
import jax
import pytest
import torch

import pvw_tpu as J
import pvw_tpu.parallel as JP
from pvw_tpu.config import settings as jsettings
import pvw_tpu_torch as P
import pvw_tpu_torch.parallel as TP
from pvw_tpu_torch import convert
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.errors import InvalidParameters

MODULI = (0xFFFFEE001, 0xFFFFC4001)
MODULI4 = (0x80000000080001, 0x80000000130001, 0x80000000190001, 0x800000001D0001)
HUGE = 1 << 56
CPU = torch.device("cpu")


class System:
    """One JAX system (CRS, n parties' keys) and the port's copy of it."""

    def __init__(self, n, k, moduli, bounds=None, seed=0):
        if bounds is None:
            bounds = J.PvwParameters.suggest_error_bounds(n, k, 8, moduli, 0.5)
        self.jp = (J.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(8)
                   .set_moduli(moduli).set_secret_variance(0.5)
                   .set_error_bounds(*bounds).build())
        key = jax.random.key(seed)
        crs = J.PvwCrs.new(self.jp, jax.random.fold_in(key, 0))
        self.jparties = [J.Party.new(i, self.jp, jax.random.fold_in(key, 100 + i))
                         for i in range(n)]
        self.jgpk = J.GlobalPublicKey(crs)
        self.jgpk.generate_all_party_keys(self.jparties, jax.random.fold_in(key, 1))
        self.tp = convert.params_from_dict(self.jp.to_dict())
        self.tgpk = convert.global_pk_from_residues(
            self.jgpk.matrix.residues_np(),
            convert.crs_from_residues(crs.matrix.residues_np(), self.tp, device="cpu"))
        self.key = jax.random.fold_in(key, 5)
        self.tkey = convert.key_from_words(np.asarray(jax.random.key_data(self.key)))

    def tsk(self, i):
        return convert.secret_key_from_coeffs(self.jparties[i].secret_key.secret_coeffs,
                                              self.tp)


@pytest.fixture(scope="module")
def toy():
    return System(8, 8, MODULI)


@pytest.fixture(scope="module")
def four():
    return System(8, 8, MODULI4, bounds=(100, 200), seed=17)


@pytest.fixture(scope="module")
def huge():
    return System(8, 8, MODULI4, bounds=(HUGE, HUGE), seed=11)


@pytest.fixture
def stream(request):
    jsettings.noise_stream = tsettings.noise_stream = request.param
    yield request.param
    del jsettings.noise_stream, tsettings.noise_stream


def assert_same(tct, jct):
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())


def scalars(d, n, seed):
    v = np.random.default_rng(seed).integers(0, 1 << 32, (d, n), dtype=np.uint64)
    v[0, 0] = (1 << 64) - 1                       # the `as i64` wrap: decodes to 0
    return v


def shares(sc, i):
    """What party i decrypts from every dealer of ``sc``."""
    return [0 if v == (1 << 64) - 1 else int(v) for v in sc[:, i]]


# --------------------------------------------------------------------------
# the dealer split
# --------------------------------------------------------------------------

@pytest.mark.parametrize("stream", ["v3k"], indirect=True)
@pytest.mark.parametrize("shards,offsets", [(2, [0, 3]), (3, [0, 2, 4]),
                                            (8, [0, 1, 2, 3, 4])])
def test_data_parallel_v3k_bit_identical(toy, stream, shards, offsets):
    """Under v3k every shard draws the columns the full batch would: the
    gathered ciphertext is the single-device one (5 dealers: ragged
    blocks; 8 devices give 5 shards), and decrypts."""
    sc = scalars(5, 8, 6)
    ct = TP.encrypt_batch_data_parallel(sc, toy.tgpk, toy.tkey, [CPU] * shards)
    assert ct.offsets == offsets
    g = ct.gather()
    assert_same(g, P.encrypt_batch(sc, toy.tgpk, toy.tkey))
    assert_same(g, J.encrypt_batch(sc, toy.jgpk, toy.key))


def test_data_parallel_default_stream_equals_jax(toy):
    """Outside the v3k contract each shard takes ``fold_in(key, 1_000_003 +
    idx)``: the shards equal the JAX package's, byte for byte."""
    sc = scalars(8, 8, 7)
    t = TP.encrypt_batch_data_parallel(sc, toy.tgpk, toy.tkey, [CPU] * 3)
    j = JP.encrypt_batch_data_parallel(sc, toy.jgpk, toy.key, jax.devices()[:3])
    assert t.offsets == [int(o) for o in j.offsets]
    assert_same(t.gather(), j.gather())
    assert P.decrypt_party_shares(t.gather(), toy.tsk(2), 2) == shares(sc, 2)


def test_data_parallel_no_randomness_reuse(toy):
    """Under the default stream two shards encrypting the same local
    column must not share r: their c1 columns differ almost everywhere."""
    sc = scalars(8, 8, 8)
    ct = TP.encrypt_batch_data_parallel(sc, toy.tgpk, toy.tkey, [CPU] * 2)
    c0 = ct.shards[0][0][..., 0]
    c1 = ct.shards[1][0][..., 0]
    assert (c0 != c1).double().mean() > 0.5


# bounds between 32639 and min q (residue noise after the fused matmul, on
# one product or both), on the 4 x 55-bit chain, with the stream
RESIDUE_CASES = [(b, st) for b in ((40000, 50000), (1 << 40, 1 << 41), (100, 1 << 40))
                 for st in ("kernel", "v3k")]
RESIDUE_IDS = [f"{b1}-{b2}-{st}" for (b1, b2), st in RESIDUE_CASES]


@functools.lru_cache(maxsize=None)
def residue_system(bounds):
    return System(8, 8, MODULI4, bounds=bounds, seed=bounds[0] % 97)


@contextlib.contextmanager
def residue_stream(stream):
    jsettings.noise_stream = tsettings.noise_stream = stream
    try:
        yield
    finally:
        del jsettings.noise_stream, tsettings.noise_stream


@pytest.mark.parametrize("bounds,stream_name", RESIDUE_CASES, ids=RESIDUE_IDS)
def test_data_parallel_residue_bounds_equal_jax(bounds, stream_name):
    """A 2-way dealer split at bounds between 32639 and min q (residue
    noise): the JAX package's shards, byte for byte."""
    system = residue_system(bounds)
    sc = scalars(4, 8, 13)
    with residue_stream(stream_name):
        t = TP.encrypt_batch_data_parallel(sc, system.tgpk, system.tkey, [CPU] * 2)
        j = JP.encrypt_batch_data_parallel(sc, system.jgpk, system.key, jax.devices()[:2])
    assert_same(t.gather(), j.gather())


def test_data_parallel_huge_bound_refused(huge):
    with pytest.raises(InvalidParameters, match="data-parallel"):
        TP.encrypt_batch_data_parallel(np.ones((4, 8), np.uint64), huge.tgpk, huge.tkey,
                                       [CPU] * 2)


# --------------------------------------------------------------------------
# limbs, and limb groups x the mesh
# --------------------------------------------------------------------------

def test_restrict_limbs(four):
    """A limb view keeps the full q's Δ, gadget and identity: its gadget
    residues are the full gadget's limbs, equal to the JAX package's view;
    it differs from a parameter set built on the subset and refuses
    ``to_dict``."""
    sub = four.tp.restrict_limbs((1, 2))
    jsub = four.jp.restrict_limbs((1, 2))
    assert sub.delta() == four.tp.delta() and sub.q_total() == four.tp.q_total()
    assert sub.ring.moduli == MODULI4[1:3]
    np.testing.assert_array_equal(sub.gadget_ntt, four.tp.gadget_ntt[1:3])
    for name in ("gadget_ntt", "gadget_ntt_shoup", "gadget_wrap"):
        np.testing.assert_array_equal(getattr(sub, name), getattr(jsub, name))
    native = P.PvwParameters(8, 8, 8, MODULI4[1:3], 0.5, 100, 200)
    assert native != sub and sub == four.tp.restrict_limbs([1, 2])
    assert hash(sub) == hash(four.tp.restrict_limbs((1, 2)))
    with pytest.raises(P.errors.SerializationError):
        sub.to_dict()
    with pytest.raises(InvalidParameters, match="invalid limb"):
        four.tp.restrict_limbs((4,))


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_limb_parallel_bit_identical(four, shards):
    """The limb shards concatenate to the single-device ciphertext (JAX's
    too) and decrypt; 3 shards of 4 limbs are ragged."""
    assert TP.limb_partition(4, shards) == JP.limb_partition(4, shards)
    sc = scalars(3, 8, 9)
    ct = TP.encrypt_batch_limb_parallel(sc, four.tgpk, four.tkey, [CPU] * shards)
    assert_same(ct.gather(), J.encrypt_batch(sc, four.jgpk, four.key))
    assert TP.decrypt_party_shares_limb_parallel(ct, four.tsk(4), 4) == \
        shares(sc, 4)


@pytest.mark.parametrize("bounds,stream_name", [(None, None)] + RESIDUE_CASES,
                         ids=["huge"] + RESIDUE_IDS)
def test_limb_parallel_huge_bound(huge, bounds, stream_name):
    """Every limb shard reduces the same host-sampled integers (4 shards);
    at bounds between 32639 and min q (residue noise) a 2-way limb split
    under both streams: the JAX package's single-device bytes."""
    system = huge if bounds is None else residue_system(bounds)
    sc = scalars(4, 8, 10)
    with residue_stream(stream_name) if bounds else contextlib.nullcontext():
        ct = TP.encrypt_batch_limb_parallel(sc, system.tgpk, system.tkey,
                                            [CPU] * (4 if bounds is None else 2))
        want = J.encrypt_batch(sc, system.jgpk, system.key)
    assert_same(ct.gather(), want)
    assert TP.decrypt_party_shares_limb_parallel(ct, system.tsk(2), 2) == \
        shares(sc, 2)


@pytest.mark.parametrize("stream", ["kernel", "v3k"], indirect=True)
@pytest.mark.parametrize("limb_groups,kdim", [(2, 2), (2, 1), (4, 2)])
def test_grid_bit_identical(four, stream, limb_groups, kdim):
    """Limb groups x (recv, kdim) meshes: the gathered ciphertext is the
    single-device one, the JAX package's and the port's; decryption exact.
    (JAX's own grid is held to its single-device ciphertext by
    ``tests/test_sharding.py``.)"""
    sc = scalars(4, 8, 11)
    ct = TP.encrypt_batch_grid(sc, four.tgpk, four.tkey, [CPU] * 8, limb_groups=limb_groups,
                               kdim=kdim)
    assert_same(ct.gather(), J.encrypt_batch(sc, four.jgpk, four.key))
    assert_same(ct.gather(), P.encrypt_batch(sc, four.tgpk, four.tkey))
    assert TP.decrypt_party_shares_grid(ct, four.tsk(1), 1) == shares(sc, 1)


@pytest.mark.parametrize("bounds,stream_name", [(None, None)] + RESIDUE_CASES,
                         ids=["huge"] + RESIDUE_IDS)
def test_grid_huge_bound(huge, bounds, stream_name):
    """A grid of 8 (2 limb groups x a (2, 2) mesh) at bounds >= min q and
    between 32639 and min q (residue noise, both streams): the JAX package's
    single-device bytes."""
    system = huge if bounds is None else residue_system(bounds)
    sc = scalars(4, 8, 12)
    with residue_stream(stream_name) if bounds else contextlib.nullcontext():
        ct = TP.encrypt_batch_grid(sc, system.tgpk, system.tkey, [CPU] * 8, limb_groups=2,
                                   kdim=2)
        want = J.encrypt_batch(sc, system.jgpk, system.key)
    assert_same(ct.gather(), want)
    assert TP.decrypt_party_shares_grid(ct, system.tsk(2), 2) == shares(sc, 2)
    if bounds is None:
        with pytest.raises(InvalidParameters, match="limb groups"):
            TP.encrypt_batch_grid(sc, huge.tgpk, huge.tkey, [CPU] * 6, limb_groups=4)
