"""Each stage of a PVSS round has one definition in the port, which the
single device and the mesh both call, on the CPU at tiny shapes.

- the r-stage (``encryption._r_operand``): a kdim shard's band of its k
  block is the matching k-columns of the whole band, under v3 and v3k;
- the noise route (``encryption._product``): the route each (bound, stream)
  takes, the same on a single device and on a whole-k mesh shard;
- the contraction (``decryption._contraction``): summed over k blocks and
  finished (``_noisy_finish``), it equals ``_noisy_messages``.

Residues are canonical and the band is int8 digits: equality is exact.
"""

import numpy as np
import pytest
import torch

import pvw_tpu_torch as P
import pvw_tpu_torch.parallel as TP
from pvw_tpu_torch import random as R
from pvw_tpu_torch.config import settings
from pvw_tpu_torch.crypto import decryption as tdec, encryption as tenc
from pvw_tpu_torch.parallel import sharding as tsharding

from _torch_systems import CPU, HUGE, MODULI4

N, K = 4, 8


def params(b2: int = 50):
    return P.PvwParameters(N, K, 8, MODULI4, 0.5, 50, b2)


def system(p):
    """A port-only system of ``p``: CRS, N parties' keys, on the CPU."""
    crs = P.PvwCrs.new(p, R.key(1), device="cpu")
    parties = [P.Party.new(i, p, R.fold_in(R.key(2), i), device="cpu") for i in range(N)]
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, R.key(3))
    return gpk


@pytest.fixture
def stream(request):
    settings.noise_stream = request.param
    try:
        yield settings.kernel_noise_stream()
    finally:
        del settings.noise_stream


@pytest.mark.parametrize("stream", ["v3", "v3k"], indirect=True)
@pytest.mark.parametrize("kd", [2, 4])
def test_shard_r_band_is_the_whole_bands_k_block(stream, kd, monkeypatch):
    """The band of r's rows [j*kc, (j+1)*kc) equals k-columns [j*kc*nd,
    (j+1)*kc*nd) of the whole band (r is keyed by global row), and a
    (1, kd) mesh's shards ask ``_r_operand`` for exactly those blocks."""
    p = params()
    nd, kc, d = p.ring.num_digits, K // kd, 3
    k_r = R.key(7)
    whole = tenc._r_operand(p, k_r, (0, K), d, stream, 0, CPU)
    for j in range(kd):
        block = tenc._r_operand(p, k_r, (j * kc, kc), d, stream, 0, CPU)
        assert torch.equal(block, whole[:, :, :, j * kc * nd:(j + 1) * kc * nd])
    asked = []
    real = tsharding._r_operand
    monkeypatch.setattr(tsharding, "_r_operand",
                        lambda *a, **kws: asked.append(a[2]) or real(*a, **kws))
    gpk = system(p)
    sc = np.arange(2 * N, dtype=np.uint64).reshape(2, N)
    ct = TP.encrypt_batch_sharded(sc, gpk, R.key(9), TP.make_mesh([CPU] * kd, kdim=kd))
    assert asked == [(j * kc, kc) for j in range(kd)]
    ref = P.encrypt_batch(sc, gpk, R.key(9))
    assert torch.equal(ct.c1.channel(), ref.c1.channel())
    assert torch.equal(ct.c2.channel(), ref.c2.channel())


def record_routes(monkeypatch):
    """The noise route of each fused product that ``_product`` runs:
    "generator" (planes of the v3k generator), "planes" (v3 planes),
    "residue" (residue noise as kernel 1's ``post=``) or "host" (a bare
    product, the host noise added after it)."""
    routes, generated, hosted = [], [], []
    real_gen, real_mm, real_host = (tenc.gen_noise_planes, tenc.matmul_fold_scaled,
                                    tenc._host_noise_ch)

    def gen(*a):
        generated.append(real_gen(*a))
        return generated[-1]

    def product(*a, **kws):
        noise, post = kws.get("noise"), kws.get("post")
        routes.append("generator" if any(noise is g for g in generated) else
                      "planes" if noise is not None else
                      "residue" if post is not None else "host" if hosted else "bare")
        return real_mm(*a, **kws)

    monkeypatch.setattr(tenc, "gen_noise_planes", gen)
    monkeypatch.setattr(tenc, "matmul_fold_scaled", product)
    monkeypatch.setattr(tenc, "_host_noise_ch",
                        lambda *a: hosted.append(1) or real_host(*a))
    return routes


@pytest.mark.parametrize("b2,stream,route", [
    (50, "v3k", "generator"), (50, "v3", "planes"), (1172385, "v3k", "residue"),
    (HUGE, "v3k", "host")], indirect=["stream"])
def test_noise_route_is_decided_once(b2, stream, route, monkeypatch):
    """c2's noise route for its bound and stream (c1's bound, 50, takes the
    generator under v3k and planes under v3), the same on a single device
    and on each shard of a (2, 1) mesh, which runs ``_product`` as the
    single device does; the ciphertexts are equal."""
    gpk = system(params(b2))
    sc = np.arange(2 * N, dtype=np.uint64).reshape(2, N)
    routes = record_routes(monkeypatch)
    single = P.encrypt_batch(sc, gpk, R.key(9))
    c1_route = "generator" if stream == "v3k" else "planes"
    assert routes == [c1_route, route]
    routes.clear()
    meshed = TP.encrypt_batch_sharded(sc, gpk, R.key(9), TP.make_mesh([CPU] * 2, kdim=1))
    assert routes == [c1_route, route, route]           # c1 on recv row 0, c2 on both
    assert torch.equal(meshed.c1.channel(), single.c1.channel())
    assert torch.equal(meshed.c2.channel(), single.c2.channel())


@pytest.mark.parametrize("kd", [2, 4])
def test_contraction_over_k_blocks_then_finished(kd):
    """<s, c1> contracted a k block at a time, the partials added mod q and
    finished (minus c2, inverse NTT) equals ``_noisy_messages``, on random
    canonical residues."""
    p = params()
    ring, d, kc = p.ring, 5, K // kd
    L, l = ring.num_limbs, ring.degree
    gen = torch.Generator().manual_seed(kd)
    q = ring.table("q", CPU)

    def residues(*shape, limb_axis):
        view = [1] * len(shape)
        view[limb_axis] = L
        return torch.randint(0, 1 << 62, shape, generator=gen) % q.reshape(view)

    sk = residues(K, L, l, limb_axis=1)
    c1, c2 = residues(L, l, K, d, limb_axis=0), residues(L, l, d, limb_axis=0)
    parts = [tdec._contraction(ring, sk[j * kc:(j + 1) * kc], c1[:, :, j * kc:(j + 1) * kc])
             for j in range(kd)]
    z = tdec._noisy_finish(ring, tsharding._modsum_gathered(parts, ring, CPU), c2)
    assert torch.equal(z, tdec._noisy_messages(p, sk, c1, c2))
    assert not torch.equal(parts[0], tdec._contraction(ring, sk, c1))   # a block is partial
