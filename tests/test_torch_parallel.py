"""The port's (recv, kdim) mesh against the JAX package's, on the CPU (the
other backends: ``tests/test_torch_parallel_backends.py``).

JAX runs its meshes on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's meshes repeat the one CPU device (a device may repeat in a
mesh). Both packages encrypt from the same CRS and key matrix (carried over
by ``convert.py``) under the same keys; ciphertexts are compared byte for
byte and decryptions exactly (tolerance 0: every residue is canonical).

Under v3k the port's CPU takes kernel 1's masked form at kdim > 1 (its
``kernel_noise_available`` holds on the CPU), while the JAX package's CPU
takes the bake route (``kernel_noise_available`` is False off the TPU), so
equal bytes hold the masked contract against the bake route.
"""

import numpy as np
import jax
import pytest

import pvw_tpu.parallel as JP
from pvw_tpu.ops import pallas_modmat as jpm
import pvw_tpu_torch as P
import pvw_tpu_torch.parallel as TP
from pvw_tpu_torch.crypto import encryption as tenc
from pvw_tpu_torch.errors import InvalidParameters
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.parallel import sharding as tsharding

from _torch_systems import (CPU, HUGE, MODULI, MODULI4, RESIDUE_CASES, assert_same,
                            jax_encrypt_batch, make_system, noise_stream,
                            residue_system, scalars, shares)


@pytest.fixture(scope="module")
def toy():
    return make_system(8, 8, MODULI)


@pytest.fixture(scope="module")
def six():
    return make_system(6, 8, MODULI, seed=3)


@pytest.fixture(scope="module")
def huge():
    return make_system(8, 8, MODULI4, bounds=(HUGE, HUGE), seed=11)


@pytest.fixture
def stream(request):
    with noise_stream(request.param):
        yield request.param


def seed_words(monkeypatch):
    """The seed word counts of the port's sharded products, one a product
    (None: no generated noise), recorded as they run: each launch of the
    v3k generator (6 words where masked, else 4) joins the fused matmul
    that reads it, whether the shard's product runs through
    ``encryption._product`` or the bake route."""
    seen, words = [], []
    real_gen, real_mm = tfm.v3k_noise_planes, tsharding.matmul_fold_scaled

    def gen(*a, **kws):
        mask = a[9] if len(a) > 9 else kws.get("mask")
        words.append(4 if mask is None else 6)
        return real_gen(*a, **kws)

    def product(*a, **kws):
        out = real_mm(*a, **kws)
        seen.append(words.pop() if words else None)
        return out

    monkeypatch.setattr(tfm, "v3k_noise_planes", gen)
    for module in (tenc, tsharding):
        monkeypatch.setattr(module, "matmul_fold_scaled", product)
    return seen


# --------------------------------------------------------------------------
# the (recv, kdim) mesh
# --------------------------------------------------------------------------

@pytest.mark.parametrize("count,kdim,shape", [
    (8, None, (4, 2)), (8, 4, (2, 4)), (3, None, (3, 1)), (1, None, (1, 1))])
def test_make_mesh(count, kdim, shape):
    """JAX's kdim rule (2 for an even count >= 2, else 1) over a repeated
    device; the same shape as ``jax``'s mesh of as many devices."""
    mesh = TP.make_mesh([CPU] * count, kdim=kdim)
    assert (mesh.shape["recv"], mesh.shape["kdim"]) == shape
    jmesh = JP.make_mesh(jax.devices()[:count], kdim=kdim)
    assert (jmesh.shape["recv"], jmesh.shape["kdim"]) == shape
    assert all(d == CPU for row in mesh.devices for d in row)


def test_make_mesh_refuses():
    with pytest.raises(InvalidParameters, match="not divisible"):
        TP.make_mesh([CPU] * 8, kdim=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TP.make_mesh()                            # the default: every CUDA device


@pytest.mark.parametrize("stream", ["kernel", "v3k"], indirect=True)
@pytest.mark.parametrize("recv,kdim", [(8, 1), (4, 2), (2, 4)])
def test_sharded_encrypt_equals_jax(toy, stream, recv, kdim, monkeypatch):
    """c1 and c2 equal ``pvw_tpu``'s ``encrypt_batch_sharded`` and the
    port's single-device encryption; the port takes the masked form on
    every v3k kdim > 1 shard and the JAX package's CPU the bake route; c1 is
    computed on recv row 0's shards only, c2 on every shard."""
    sc = scalars(2, 8, 1)
    seen = seed_words(monkeypatch)
    tct = TP.encrypt_batch_sharded(sc, toy.tgpk, toy.tkey,
                                   TP.make_mesh([CPU] * 8, kdim=kdim))
    sharded = list(seen)
    jct = JP.encrypt_batch_sharded(sc, toy.jgpk, toy.key,
                                   JP.make_mesh(jax.devices(), kdim=kdim))
    assert_same(tct, jct)
    assert_same(tct, P.encrypt_batch(sc, toy.tgpk, toy.tkey))
    want = 6 if kdim > 1 else 4
    assert sharded == [want if stream == "v3k" else None] * ((1 + recv) * kdim)
    assert not jpm.kernel_noise_available(toy.jp.ring, 8, 2, 8 // kdim, 50, tfry=True)


@pytest.mark.parametrize("stream", ["kernel", "v3k"], indirect=True)
def test_sharded_encrypt_ragged_rows(six, stream):
    """n = 6 over (recv 2, kdim 4): 3 local rows in blocks of 1, one block
    past the rows (the bake route pads it; the masked range clips it)."""
    sys6 = six
    sc = scalars(4, 6, 2)
    tct = TP.encrypt_batch_sharded(sc, sys6.tgpk, sys6.tkey, TP.make_mesh([CPU] * 8, kdim=4))
    jct = JP.encrypt_batch_sharded(sc, sys6.jgpk, sys6.key,
                                   JP.make_mesh(jax.devices(), kdim=4))
    assert_same(tct, jct)
    for i in (0, 5):
        assert TP.decrypt_party_shares_sharded(tct, sys6.tsk(i), i, TP.make_mesh(
            [CPU] * 4, kdim=2)) == shares(sc, i)


@pytest.mark.parametrize("kdim,residue,force", [(1, None, False), (2, None, False)] + [
    (kdim, case, force) for case in RESIDUE_CASES for kdim, force in
    ((1, False), (2, False), (4, False), (1, True))], ids=["1", "2"] + [
    f"{b1}-{b2}-{st}-kdim{kdim}{'-forced' if force else ''}" for (b1, b2), st in
    RESIDUE_CASES for kdim, force in ((1, False), (2, False), (4, False), (1, True))])
def test_sharded_encrypt_huge_bound(huge, kdim, residue, force):
    """Bounds >= min q: the exact host noise, added after the gather. And
    bounds between 32639 and min q (residue noise: (40000, 50000), (2^40,
    2^41), (100, 2^40)) under both streams, at kdim 1, 2 and 4 and forced
    masked: the JAX package's bytes."""
    system = huge if residue is None else residue_system(residue[0])
    with noise_stream(None if residue is None else residue[1]):
        sc = scalars(4, 8, 3)
        tmesh = TP.make_mesh([CPU] * 4, kdim=kdim)
        tct = TP.encrypt_batch_sharded(sc, system.tgpk, system.tkey, tmesh,
                                       _force_masked=force)
        jct = JP.encrypt_batch_sharded(sc, system.jgpk, system.key,
                                       JP.make_mesh(jax.devices()[:4], kdim=kdim),
                                       _force_masked=force)
    assert_same(tct, jct)
    assert TP.decrypt_party_shares_sharded(tct, system.tsk(1), 1, tmesh) == \
        shares(sc, 1)


@pytest.mark.parametrize("stream", ["v3k"], indirect=True)
def test_sharded_encrypt_force_masked(toy, stream, monkeypatch):
    """``_force_masked`` at (8, 1): the masked form on every product (c1 on
    recv row 0, c2 on all 8 shards), its range the shard's whole block, the
    same bytes as the JAX package's."""
    sc = scalars(2, 8, 4)
    seen = seed_words(monkeypatch)
    tct = TP.encrypt_batch_sharded(sc, toy.tgpk, toy.tkey, TP.make_mesh([CPU] * 8, kdim=1),
                                   _force_masked=True)
    jct = JP.encrypt_batch_sharded(sc, toy.jgpk, toy.key,
                                   JP.make_mesh(jax.devices(), kdim=1), _force_masked=True)
    assert_same(tct, jct)
    assert seen == [6] * 9


@pytest.mark.parametrize("layout", ["channel-major", "canonical"])
@pytest.mark.parametrize("kdim", [1, 2, 4])
def test_sharded_decrypt(toy, layout, kdim):
    """Dealers over recv, the contraction over kdim: every share equals the
    single-device decryption and the plaintext, and at kdim 2 JAX's sharded
    decryption."""
    sc = scalars(8, 8, 5)
    tct = P.encrypt_batch(sc, toy.tgpk, toy.tkey)
    if layout == "canonical":
        tct = P.PvwCiphertext(P.Poly(tct.c1.res, tct.c1.rep, tct.c1.ring),
                              P.Poly(tct.c2.res, tct.c2.rep, tct.c2.ring), tct.params)
    assert tct.c1.is_channel_major == (layout == "channel-major")
    for i in (0, 5):
        got = TP.decrypt_party_shares_sharded(tct, toy.tsk(i), i,
                                              TP.make_mesh([CPU] * 8, kdim=kdim))
        assert got == shares(sc, i)
        assert got == P.decrypt_party_shares(tct, toy.tsk(i), i)
        if kdim == 2:
            assert got == JP.decrypt_party_shares_sharded(
                jax_encrypt_batch(toy, 8, 5), toy.jparties[i].secret_key, i,
                JP.make_mesh(jax.devices(), kdim=2))


def test_sharded_divisibility_refused(toy):
    sc = np.zeros((3, 8), np.uint64)
    with pytest.raises(InvalidParameters, match="must divide"):
        TP.encrypt_batch_sharded(sc, toy.tgpk, toy.tkey, TP.make_mesh([CPU] * 3, kdim=1))
    ct = P.encrypt_batch(sc, toy.tgpk, toy.tkey)
    with pytest.raises(InvalidParameters, match="dealer batch 3 must divide"):
        TP.decrypt_party_shares_sharded(ct, toy.tsk(0), 0, TP.make_mesh([CPU] * 4, kdim=2))
