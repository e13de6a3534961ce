"""The port's CUDA kernel against its plain PyTorch twin, on a card.

Every test here is marked ``cuda`` and skips without a card: the kernel
has no CPU mode. This file imports neither ``jax`` nor ``pvw_tpu``, so it
runs on a machine with PyTorch alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` configures JAX.) Residues are
held to exact equality.
"""

import numpy as np
import pytest
import torch

from pvw_tpu_torch.ops import fused_modmat as fm
from pvw_tpu_torch.ops import modmat, ntt, u64
from pvw_tpu_torch.params.ring import RingPlan

TOY = (0xFFFFC4001, 0x1FFFFE0001)
BIG = (0x800000022A0001, 0x800000021A0001)     # 55-bit primes: nd = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def rand_u64(rng, shape):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=shape, dtype=np.uint64)


def operands(moduli, jr, encode, seed, m, k, n):
    rng = np.random.default_rng(seed)
    ring = RingPlan(moduli, 8)
    L, S, nd = ring.num_limbs, 8, ring.num_digits
    qs = ring.q.reshape(L, 1, 1, 1)
    lhs_dig = modmat.digits(u64.u64_tensor(rand_u64(rng, (L, S, m, k)) % qs), nd)
    band = modmat.prescale_digits_band(u64.u64_tensor(rand_u64(rng, (L, S, k, n)) % qs), ring)
    noise = None
    bound = 50 if jr == 1 else 2000
    if jr:
        ev = rng.integers(-bound, bound + 1, (m, n, 8)).astype(np.int32)
        noise = ntt._digit_planes(torch.from_numpy(ev), jr)
    enc = None
    if encode:
        sc = rand_u64(rng, (m, n))
        sc[0, :3] = [0, 1 << 63, (1 << 64) - 1]
        if encode == "enc32":
            sc &= np.uint64(0xFFFFFFFF)
        g = rand_u64(rng, (L, S)) % ring.q[:, None]
        gs = np.array([[(int(g[i, s]) << 64) // q for s in range(S)]
                       for i, q in enumerate(moduli)], object)
        wrap = np.array([[pow(2, 64, q) * int(g[i, s]) % q for s in range(S)]
                         for i, q in enumerate(moduli)], np.uint64)
        etab = fm.encode_tab(g, (gs & 0xFFFFFFFFFFFFFFFF).astype(np.uint64), wrap)
        enc = (u64.u64_tensor(sc), u64.u64_tensor(etab))
    return ring, lhs_dig.reshape(L, S, m, k * nd), band, noise, bound, enc


@pytest.mark.cuda
@pytest.mark.parametrize("moduli,jr,encode,vals", [
    (TOY, 1, None, True), (TOY, 2, "enc64", False), (TOY, 0, "enc32", False),
    (BIG, 1, "enc32", True), (BIG, 2, "enc64", True), (BIG, 2, None, False),
])
def test_kernel_equals_plain_twin(cuda_device, moduli, jr, encode, vals):
    from pvw_tpu_torch.config import settings

    ring, lhs_dig, band, noise, bound, enc = operands(moduli, jr, encode, 25,
                                                      m=70, k=33, n=130)
    want = fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc, lhs_dig=lhs_dig)
    move = lambda t: None if t is None else t.to(cuda_device)
    before = fm.fused_scaled_noise_matmul.launches
    settings.noise_value_mac = vals
    try:
        got = fm.matmul_fold_scaled(
            None, move(band), ring, noise=move(noise),
            encode=None if enc is None else tuple(map(move, enc)),
            lhs_dig=move(lhs_dig), encode32=encode == "enc32", noise_bound=bound)
    finally:
        del settings.noise_value_mac
    torch.cuda.synchronize()
    assert fm.fused_scaled_noise_matmul.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_demo_roundtrip_on_the_card(cuda_device):
    import pvw_tpu_torch

    assert pvw_tpu_torch.demo_roundtrip(verbose=False, device=cuda_device)


def _toy_system(device):
    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R

    b1, b2 = P.PvwParameters.suggest_error_bounds(5, 16, 8, TOY, 0.5)
    params = P.PvwParameters(5, 16, 8, TOY, 0.5, b1, b2)
    key = R.key(7)
    crs = P.PvwCrs.new(params, R.fold_in(key, 1), device=device)
    parties = [P.Party.new(i, params, R.fold_in(key, 10 + i), device=device)
               for i in range(5)]
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, R.fold_in(key, 2))
    return params, gpk, parties, key


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["kernel", "v3k"])
def test_card_path_equals_cpu_path(cuda_device, stream):
    """Keygen and encryption on the card give the CPU's residues, for the
    default stream and v3k, including scalars >= 2^63."""
    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings

    sc = np.array([[1, 2, 1 << 63, (1 << 64) - 1, 5], [0, 7, 8, 9, 1 << 40]], np.uint64)
    out = {}
    settings.noise_stream = stream
    try:
        for dev in ("cpu", cuda_device):
            params, gpk, parties, key = _toy_system(dev)
            ct = P.encrypt_batch(sc, gpk, R.fold_in(key, 3))
            out[str(dev)] = (gpk.matrix.residues_np(), ct.c1.residues_np(),
                             ct.c2.residues_np())
    finally:
        del settings.noise_stream
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_exact_int_matmul_on_the_card(cuda_device):
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, size=(3, 70, 1280), dtype=np.int64).astype(np.int8)
    b = rng.integers(-128, 128, size=(3, 1280, 90), dtype=np.int64).astype(np.int8)
    a[0, 0], b[0, :, 0] = -128, -128                  # the largest column
    got = modmat.exact_int_matmul(torch.from_numpy(a).to(cuda_device),
                                  torch.from_numpy(b).to(cuda_device))
    np.testing.assert_array_equal(got.cpu().numpy(), a.astype(np.int64) @ b.astype(np.int64))
