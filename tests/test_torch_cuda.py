"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Every test here is marked ``cuda`` and skips without a card: the kernels
have no CPU mode. This file imports neither ``jax`` nor ``pvw_tpu``, so it
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
from pvw_tpu_torch.utils.intmath import generate_ntt_primes

TOY = (0xFFFFC4001, 0x1FFFFE0001)
BIG = (0x800000022A0001, 0x800000021A0001)     # 55-bit primes: nd = 8
CHAIN_61X17 = generate_ntt_primes(61, 17, 16)  # config 4's chain: nd = 8
CHAIN_61X2_L64 = generate_ntt_primes(61, 2, 64)  # nd = 8 at the largest kernel degree


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def rand_u64(rng, shape):
    return rng.integers(0, 1 << 63, size=shape, dtype=np.uint64) * np.uint64(2) \
        + rng.integers(0, 2, size=shape, dtype=np.uint64)


def operands(moduli, jr, encode, seed, m, k, n, l=8):
    rng = np.random.default_rng(seed)
    ring = RingPlan(moduli, l)
    L, S, nd = ring.num_limbs, l, ring.num_digits
    qs = ring.q.reshape(L, 1, 1, 1)
    lhs_dig = modmat.digits(u64.u64_tensor(rand_u64(rng, (L, S, m, k)) % qs), nd)
    band = modmat.prescale_digits_band(u64.u64_tensor(rand_u64(rng, (L, S, k, n)) % qs), ring)
    noise = None
    bound = 50 if jr == 1 else 2000
    if jr:
        ev = rng.integers(-bound, bound + 1, (m, n, l)).astype(np.int32)
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
@pytest.mark.parametrize("moduli,jr,encode,vals,l", [
    (TOY, 1, None, True, 8), (TOY, 2, "enc64", False, 8), (TOY, 0, "enc32", False, 8),
    (BIG, 1, "enc32", True, 8), (BIG, 2, "enc64", True, 8), (BIG, 2, None, False, 8),
    (CHAIN_61X17, 1, "enc64", True, 16), (CHAIN_61X17, 2, "enc32", False, 16),
])
def test_kernel_equals_plain_twin(cuda_device, moduli, jr, encode, vals, l):
    """The fused matmul; the 61-bit rows are CH = 272 channels at nd = 8."""
    from pvw_tpu_torch.config import settings

    m, k, n = (70, 33, 130) if l == 8 else (40, 9, 70)
    ring, lhs_dig, band, noise, bound, enc = operands(moduli, jr, encode, 25,
                                                      m=m, k=k, n=n, l=l)
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
@pytest.mark.parametrize("moduli,l,m,k,n,jr", [
    (TOY, 8, 80, 32, 48, 1), (CHAIN_61X17, 16, 72, 16, 48, 1),
    (TOY, 8, 70, 33, 129, 2), (CHAIN_61X17, 16, 40, 9, 69, 1),
])
def test_kernel_tile_edges_equal_plain_twin(cuda_device, moduli, l, m, k, n, jr):
    """The fused matmul with m and n off its 64 x 32 tile: k*nd and n
    multiples of 16 (rows taken as they lie), and odd k*nd and n (rows
    zero-padded to 16 bytes for TMA)."""
    ring, lhs_dig, band, noise, bound, enc = operands(moduli, jr, "enc64", 27,
                                                      m=m, k=k, n=n, l=l)
    want = fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc, lhs_dig=lhs_dig)
    move = lambda t: t.to(cuda_device)
    got = fm.matmul_fold_scaled(None, move(band), ring, noise=move(noise),
                                encode=tuple(map(move, enc)), lhs_dig=move(lhs_dig),
                                noise_bound=bound)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("moduli,l,bound,k,d", [
    (TOY, 8, 1, 16, 128), (TOY, 8, 200, 5, 130), (CHAIN_61X17, 16, 1, 8, 1000),
    (CHAIN_61X17, 16, 2000, 3, 70), (TOY, 64, 1, 4, 70), (CHAIN_61X2_L64, 64, 2000, 3, 130),
])
def test_prescale_kernel_equals_plain_twin(cuda_device, moduli, l, bound, k, d):
    """The fused r-stage: nd = 5 and config 4's chain, jr = 1 and 2, d off
    the kernel's 256-column tile and off its 4-column quads, and l = 64
    (the twiddle digits' 74 KB of dynamic shared memory at jr = 2)."""
    ring = RingPlan(moduli, l)
    rng = np.random.default_rng(26)
    c = torch.from_numpy(rng.integers(-bound, bound + 1, (k, d, l)).astype(np.int32))
    c[0, 0], c[0, 1] = bound, -bound
    want = fm.ntt_prescale_band(c, ring, bound)
    before = fm.ntt_prescale_band.launches
    got = fm.ntt_prescale_band(c.to(cuda_device), ring, bound)
    torch.cuda.synchronize()
    assert fm.ntt_prescale_band.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("nd,k", [(3, 5), (5, 3), (6, 3), (7, 6), (8, 3), (3, 16), (5, 16),
                                  (6, 8), (7, 16), (3, 37), (5, 40), (7, 33), (5, 256)])
def test_prescale_kpacked_rows_equal_plain_twin(cuda_device, nd, k):
    """Kernel 4's k-packed storage, pads included, at every nd that goes
    through the shared-memory gather (3, 5, 6, 7) and one that stores directly
    (8): k*nd off 16 bytes (15, 18, 42, 24, 111, 200, 231: pads of 1 to 14
    bytes, which must stay zero and must not spill into the next row) and
    on it (48, 80, 112, 1280), one warp's rows and several."""
    ring = RingPlan(CHAIN_BY_ND[nd], 8)
    c = torch.from_numpy(np.random.default_rng(nd).integers(-1, 2, (k, 70, 8))
                         .astype(np.int32))
    want = fm.ntt_prescale_band(c, ring, 1)
    got = fm.ntt_prescale_band(c.to(cuda_device), ring, 1)
    torch.cuda.synchronize()
    rows = lambda b: torch.as_strided(b.transpose(-1, -2),
                                      (*b.transpose(-1, -2).shape[:-1], b.stride(-1)),
                                      b.transpose(-1, -2).stride(),
                                      b.storage_offset())
    assert got.stride() == want.stride()
    assert torch.equal(rows(got).cpu(), rows(want))


@pytest.mark.cuda
def test_prescale_failures_raise(cuda_device, monkeypatch, tmp_path):
    """No fallback: a refused launch and a failed build both raise."""
    from pvw_tpu_torch.ops import _build

    c = torch.zeros((2, 8, 128), dtype=torch.int32, device=cuda_device)
    before = fm.ntt_prescale_band.launches
    with pytest.raises(ValueError, match="ring degrees"):
        fm.ntt_prescale_band(c, RingPlan(TOY, 128), 1)     # a degree it lacks raises
    monkeypatch.setattr(fm, "PRESCALE_DEGREES", (8, 16, 32, 64, 128))
    with pytest.raises(RuntimeError, match="launch failed"):
        fm.ntt_prescale_band(c, RingPlan(TOY, 128), 1)     # the kernel refuses l = 128
    assert fm.ntt_prescale_band.launches == before
    (tmp_path / "ntt_prescale_band.cu").write_text("#error deliberately broken\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fm.ntt_prescale_band(c[..., :8].contiguous(), RingPlan(TOY, 8), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("l,moduli", [(16, CHAIN_61X17), (64, CHAIN_61X2_L64)])
def test_deep_chain_encryption_reaches_the_kernel(cuda_device, monkeypatch, l, moduli):
    """Deep chains on the card (config 4's, and l = 64): the default (auto)
    r-stage launches the prescale kernel once per encryption and gives the
    CPU's residues; a failing launch raises out of the entry point."""
    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R

    params = P.PvwParameters(4, 8, l, moduli, 0.5, 50, 50)
    sc = np.array([[1, 1 << 63, (1 << 64) - 1, 5], [0, 7, 8, 1 << 40]], np.uint64)
    out = {}
    for dev in ("cpu", cuda_device):
        key = R.key(5)
        crs = P.PvwCrs.new(params, R.fold_in(key, 1), device=dev)
        parties = [P.Party.new(i, params, R.fold_in(key, 10 + i), device=dev)
                   for i in range(4)]
        gpk = P.GlobalPublicKey(crs)
        gpk.generate_all_party_keys(parties, R.fold_in(key, 2))
        before = fm.ntt_prescale_band.launches
        ct = P.encrypt_batch(sc, gpk, R.fold_in(key, 3))
        assert fm.ntt_prescale_band.launches == before + (dev != "cpu")
        out[str(dev)] = (gpk.matrix.residues_np(), ct.c1.residues_np(), ct.c2.residues_np())
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        np.testing.assert_array_equal(a, b)
    monkeypatch.setattr(fm, "_prescale_fn", lambda: (lambda *args: 700))
    with pytest.raises(RuntimeError, match="launch failed"):
        P.encrypt_batch(sc, gpk, R.fold_in(key, 4))


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
@pytest.mark.parametrize("l,bound,rows,cols,row_off,col_off", [
    (8, 50, 70, 130, 0, 0), (16, 2000, 33, 257, 5, 1000), (32, 32639, 9, 64, 0, 7),
    (8, 127, 3, 200, (1 << 32) - 2, 1 << 31)])
def test_v3k_generator_equals_plain_twin(cuda_device, l, bound, rows, cols, row_off,
                                         col_off):
    """The v3k generator: jr = 1 and 2 (the 96-bit reduction at 2*bound+1 up
    to 65279), columns off its 128-column block, offsets, and counters that
    wrap mod 2^32; every byte."""
    want = fm.v3k_noise_planes(0xDEADBEEF, 0x12345678, row_off, rows, cols, l, bound,
                               col_off, "cpu")
    before = fm.v3k_noise_planes.launches
    got = fm.v3k_noise_planes(0xDEADBEEF, 0x12345678, row_off, rows, cols, l, bound,
                              col_off, cuda_device)
    torch.cuda.synchronize()
    assert fm.v3k_noise_planes.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("moduli,l,encode", [(TOY, 8, None), (BIG, 8, "enc64"),
                                             (CHAIN_61X17, 16, "enc32")])
def test_kernel_bare_and_encode_only_equal_plain_twin(cuda_device, moduli, l, encode):
    """The fused matmul with no noise rows: bare (the scaled band alone, what
    keygen and c1 take at bounds without signed digits) and with the
    encode only (c2 there)."""
    ring, lhs_dig, band, _, _, enc = operands(moduli, 0, encode, 28, m=70, k=9, n=130, l=l)
    want = fm.matmul_fold_scaled(None, band, ring, encode=enc, lhs_dig=lhs_dig)
    move = lambda t: t.to(cuda_device)
    before = fm.fused_scaled_noise_matmul.launches
    got = fm.matmul_fold_scaled(None, move(band), ring, lhs_dig=move(lhs_dig),
                                encode=None if enc is None else tuple(map(move, enc)),
                                encode32=encode == "enc32")
    torch.cuda.synchronize()
    assert fm.fused_scaled_noise_matmul.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("bound", [50, 2000, 40000])
def test_toy_chain_encryption_on_the_card_takes_the_kernels(cuda_device, bound):
    """On the card every r-stage takes the prescale kernel (nd = 5 here), and
    v3k generates its noise with the generator: one launch per product whose
    bound has signed digits, none at 40000 (residue noise). Residues equal
    the CPU's."""
    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings

    params = P.PvwParameters(5, 16, 8, TOY, 0.5, 50, bound)
    sc = np.array([[1, 2, 1 << 63, 4, 5], [0, 7, 8, 9, 1 << 40]], np.uint64)
    out = {}
    settings.noise_stream = "v3k"
    try:
        for dev in ("cpu", cuda_device):
            key = R.key(9)
            crs = P.PvwCrs.new(params, R.fold_in(key, 1), device=dev)
            parties = [P.Party.new(i, params, R.fold_in(key, 10 + i), device=dev)
                       for i in range(5)]
            gpk = P.GlobalPublicKey(crs)
            gpk.generate_all_party_keys(parties, R.fold_in(key, 2))
            before = (fm.ntt_prescale_band.launches, fm.v3k_noise_planes.launches)
            ct = P.encrypt_batch(sc, gpk, R.fold_in(key, 3))
            after = (fm.ntt_prescale_band.launches, fm.v3k_noise_planes.launches)
            if dev != "cpu":
                assert after[0] - before[0] == 1
                assert after[1] - before[1] == (2 if bound <= 32639 else 1)
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


# --------------------------------------------------------------------------
# the swapped form and the pipelined kernel
# --------------------------------------------------------------------------

# a chain for each digit count nd = 1..8 (two limbs, l = 8)
CHAIN_BY_ND = {1: (97, 113), **{nd: generate_ntt_primes(bits, 2, 8) for nd, bits in
                                 ((2, 14), (3, 22), (4, 30), (5, 38), (6, 46), (7, 54),
                                  (8, 61))}}


def _move(t, dev):
    if t is None:
        return None
    return tuple(x.to(dev) for x in t) if isinstance(t, tuple) else t.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("nd,jr,encode,vals,m,k,n", [
    (1, 1, "enc64", True, 33, 9, 130), (2, 2, None, False, 70, 8, 129),
    (3, 0, "enc32", False, 31, 16, 128), (4, 1, "enc64", False, 64, 5, 257),
    (5, 2, "enc32", True, 70, 33, 130), (6, 0, None, False, 17, 7, 3),
    (7, 2, "enc64", True, 40, 12, 140), (8, 1, "enc32", True, 65, 9, 131),
    (8, 2, "enc64", False, 32, 16, 128)])
def test_swapped_kernel_equals_plain_twin(cuda_device, nd, jr, encode, vals, m, k, n):
    """Kernel 1's swapped form at every digit count, m and n on and off its
    tile (32 receivers x 64 dealers), k*nd on and off 16 bytes: bare, noise
    (value and digit rows), both encodes."""
    from pvw_tpu_torch.config import settings

    ring, lhs_dig, band, noise, bound, enc = operands(CHAIN_BY_ND[nd], jr, encode, 30 + nd,
                                                      m=m, k=k, n=n)
    rng = np.random.default_rng(nd)
    L, S = ring.num_limbs, 8
    a = rand_u64(rng, (m, k, L, S)) % ring.q.reshape(1, 1, L, 1)
    r = rand_u64(rng, (L, S, k, n)) % ring.q.reshape(L, 1, 1, 1)
    planes = modmat.lhs_scaled_planes(u64.u64_tensor(a), ring)
    rd = modmat.rhs_digit_cols(u64.u64_tensor(r), ring)
    want = fm.matmul_fold_swapped(planes, rd, ring, noise=noise, encode=enc)
    np.testing.assert_array_equal(     # the twin is the banded product's function
        u64.u64_numpy(want),
        u64.u64_numpy(fm.matmul_fold_scaled(
            None, modmat.prescale_digits_band(u64.u64_tensor(r), ring), ring, noise=noise,
            encode=enc, lhs_dig=modmat.lhs_digit_planes(u64.u64_tensor(a), ring))))
    before = fm.fused_scaled_noise_matmul_swapped.launches
    settings.noise_value_mac = vals
    try:
        got = fm.matmul_fold_swapped(_move(planes, cuda_device), _move(rd, cuda_device), ring,
                                     noise=_move(noise, cuda_device),
                                     encode=_move(enc, cuda_device),
                                     encode32=encode == "enc32", noise_bound=bound)
    finally:
        del settings.noise_value_mac
    torch.cuda.synchronize()
    assert fm.fused_scaled_noise_matmul_swapped.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("nd,noise_kind,encode,vals,m,k,n,offs", [
    (1, "planes1", "enc64", True, 33, 9, 130, None),
    (2, "gen2", None, False, 70, 8, 65, (0, 0)),
    (3, None, "enc32", False, 31, 16, 32, None),
    (4, "planes2", "enc64", False, 64, 5, 257, None),
    (5, "gen1", "enc32", True, 130, 32, 96, ((1 << 32) - 2, 1 << 31)),
    (6, "planes2", None, True, 17, 7, 3, None),
    (7, "gen2", "enc64", True, 40, 12, 140, (5, (1 << 32) - 7)),
    (8, "gen1", "enc64", False, 65, 9, 131, (1 << 31, 3)),
    (8, "planes1", "enc32", True, 64, 16, 64, None)])
def test_pipelined_kernel_equals_plain_twin(cuda_device, nd, noise_kind, encode, vals, m, k,
                                            n, offs):
    """The pipelined kernel at every digit count, m and n on and off its 64
    x 32 tile: input planes (jr = 1, 2), in-kernel v3k (jr = 1, 2, with row
    and column offsets whose counters wrap mod 2^32), value and digit rows,
    the encode alone, both encodes; against the twin with the generator's
    planes."""
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import tfry

    jr = int(noise_kind[-1]) if noise_kind else 0
    ring, lhs_dig, band, noise, bound, enc = operands(CHAIN_BY_ND[nd], jr, encode, 40 + nd,
                                                      m=m, k=k, n=n)
    gen = None
    if noise_kind and noise_kind.startswith("gen"):
        gen = ((0xDEADBEEF, 0x12345678, *offs), jr, bound, "tfry")
        noise = tfry.v3k_noise_digit_planes(0xDEADBEEF, 0x12345678, offs[0], m, n, 8, bound,
                                            offs[1])
    want = fm.matmul_fold_scaled_plain(None, band, ring, noise=noise, encode=enc,
                                       lhs_dig=lhs_dig)
    before = (fm.fused_pipelined_matmul.launches, fm.fused_scaled_noise_matmul.launches,
              fm.v3k_noise_planes.launches)
    settings.pipeline_fold = True
    settings.noise_value_mac = vals
    try:
        got = fm.matmul_fold_scaled(
            None, _move(band, cuda_device), ring,
            noise=None if gen else _move(noise, cuda_device), encode=_move(enc, cuda_device),
            lhs_dig=_move(lhs_dig, cuda_device), encode32=encode == "enc32",
            noise_bound=bound, gen_noise=gen)
    finally:
        del settings.pipeline_fold, settings.noise_value_mac
    torch.cuda.synchronize()
    assert (fm.fused_pipelined_matmul.launches, fm.fused_scaled_noise_matmul.launches,
            fm.v3k_noise_planes.launches) == (before[0] + 1, before[1], before[2])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("jr", [1, 2])
def test_pipelined_kernel_deep_chain_equals_plain_twin(cuda_device, jr):
    """Config 4's chain (CH = 272, nd = 8, l = 16) with in-kernel v3k."""
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import tfry

    ring, lhs_dig, band, _, bound, enc = operands(CHAIN_61X17, jr, "enc64", 50, m=70, k=9,
                                                  n=69, l=16)
    planes = tfry.v3k_noise_digit_planes(1, 2, 3, 70, 69, 16, bound, 4)
    want = fm.matmul_fold_scaled_plain(None, band, ring, noise=planes, encode=enc,
                                       lhs_dig=lhs_dig)
    settings.pipeline_fold = True
    try:
        got = fm.matmul_fold_scaled(None, band.to(cuda_device), ring,
                                    encode=_move(enc, cuda_device),
                                    lhs_dig=lhs_dig.to(cuda_device),
                                    gen_noise=((1, 2, 3, 4), jr, bound, "tfry"))
    finally:
        del settings.pipeline_fold
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_swapped_and_pipelined_failures_raise(cuda_device, monkeypatch):
    """No fallback: the pipelined kernel refuses more noise planes than it
    keeps on chip (l * jr > 32), and a failed swapped launch raises."""
    from pvw_tpu_torch.config import settings

    ring, lhs_dig, band, _, _, _ = operands(TOY, 0, None, 51, m=8, k=4, n=8, l=32)
    before = fm.fused_pipelined_matmul.launches
    settings.pipeline_fold = True
    try:
        with pytest.raises(RuntimeError, match="launch failed"):
            fm.matmul_fold_scaled(None, band.to(cuda_device), ring,
                                  lhs_dig=lhs_dig.to(cuda_device),
                                  gen_noise=((1, 2, 0, 0), 2, 2000, "tfry"))
    finally:
        del settings.pipeline_fold
    assert fm.fused_pipelined_matmul.launches == before
    monkeypatch.setattr(fm, "_kernel_fn", lambda symbol: (lambda *args: 700))
    planes = torch.zeros((2, 32, 5, 4, 20), dtype=torch.int8, device=cuda_device)
    rd = torch.zeros((2, 32, 20, 8), dtype=torch.int8, device=cuda_device)
    with pytest.raises(RuntimeError, match="launch failed"):
        fm.matmul_fold_swapped(planes, rd, ring)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["swapped", "pipelined"])
@pytest.mark.parametrize("stream", ["kernel", "v3k"])
def test_opt_in_routes_on_the_card_equal_cpu(cuda_device, route, stream):
    """Encryption of 130 dealers with each opt-in route on the card gives
    the CPU's ciphertexts, through its kernel: the swapped form launches its
    kernel for both products and not the r-stage kernel; the pipelined
    kernel runs both products with no generator launch and no kernel 1."""
    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings

    params = P.PvwParameters(5, 16, 8, TOY, 0.5, 50, 2000)
    sc = np.random.default_rng(8).integers(0, 1 << 40, (130, 5), dtype=np.uint64)
    sc[0, :2] = [1 << 63, (1 << 64) - 1]
    counted = (fm.fused_scaled_noise_matmul, fm.fused_scaled_noise_matmul_swapped,
               fm.fused_pipelined_matmul, fm.v3k_noise_planes, fm.ntt_prescale_band)
    out = {}
    settings.noise_stream = stream
    try:
        for dev in ("cpu", cuda_device):
            key = R.key(12)
            crs = P.PvwCrs.new(params, R.fold_in(key, 1), device=dev)
            parties = [P.Party.new(i, params, R.fold_in(key, 10 + i), device=dev)
                       for i in range(5)]
            gpk = P.GlobalPublicKey(crs)
            gpk.generate_all_party_keys(parties, R.fold_in(key, 2))
            setattr(settings, "swapped_form" if route == "swapped" else "pipeline_fold", True)
            try:
                before = [f.launches for f in counted]
                ct = P.encrypt_batch(sc, gpk, R.fold_in(key, 3))
                runs = [f.launches - b for f, b in zip(counted, before)]
            finally:
                del settings.swapped_form, settings.pipeline_fold
            if dev != "cpu":
                gen = 2 if stream == "v3k" else 0
                want = [0, 2, 0, gen, 0] if route == "swapped" else [0, 0, 2, 0, 1]
                assert runs == want
            out[str(dev)] = (ct.c1.residues_np(), ct.c2.residues_np())
    finally:
        del settings.noise_stream
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("moduli,l,jr,row_off,lo,hi,col_off,encode,m,k,n", [
    (TOY, 8, 1, 0, 0, 70, 0, "enc32", 140, 33, 130),       # a ragged first part
    (TOY, 8, 2, 0, 70, 140, 9, "enc64", 140, 33, 130),     # its complement, column offset
    (TOY, 8, 1, 300, 0, 0, 0, "enc64", 64, 16, 64),        # empty
    (CHAIN_61X17, 16, 2, 5, 0, 1 << 20, 3, "enc64", 70, 9, 40),   # full
    (CHAIN_61X17, 16, 1, 128, 200, 231, 0, "enc32", 130, 8, 33),  # off the 128-row tile
    (TOY, 8, 1, (1 << 32) - 40, (1 << 32) - 20, 10, 0, "enc64", 64, 16, 64),  # int32 wrap
])
def test_masked_kernel_equals_plain_twin(cuda_device, moduli, l, jr, row_off, lo, hi,
                                         col_off, encode, m, k, n):
    """Kernel 1's masked form (the generator's masked planes, then the
    encode on the global rows [lo, hi) only), launched through the 6-word
    seeds: a kernel 1 launch counted as masked, never the pipelined
    kernel's, even with ``pipeline_fold`` on."""
    from pvw_tpu_torch.config import settings

    ring, lhs_dig, band, _, bound, enc = operands(moduli, jr, encode, 28, m=m, k=k, n=n, l=l)
    g = ((0xDEADBEEF, 0x12345678, row_off, lo, hi, col_off), jr, bound, "tfry")
    want = fm.matmul_fold_scaled(None, band, ring, encode=enc, lhs_dig=lhs_dig, gen_noise=g)
    move = lambda t: t.to(cuda_device)
    counts = lambda: (fm.fused_scaled_noise_matmul.masked_launches,
                      fm.fused_scaled_noise_matmul.launches, fm.fused_pipelined_matmul.launches,
                      fm.v3k_noise_planes.launches)
    before = counts()
    settings.pipeline_fold = True
    try:
        got = fm.matmul_fold_scaled(None, move(band), ring, encode=tuple(map(move, enc)),
                                    lhs_dig=move(lhs_dig), encode32=encode == "enc32",
                                    gen_noise=g)
    finally:
        del settings.pipeline_fold
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 0, 1]
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("moduli,l,jr,encode", [(TOY, 8, 0, None), (TOY, 8, 2, "enc64"),
                                                (CHAIN_61X17, 16, 1, "enc32")])
def test_post_equals_plain_twin(cuda_device, moduli, l, jr, encode):
    """``post=`` alone and beside the noise rows and the encode."""
    ring, lhs_dig, band, noise, bound, enc = operands(moduli, jr, encode, 29,
                                                      m=70, k=9, n=130, l=l)
    rng = np.random.default_rng(30)
    post = u64.u64_tensor(rand_u64(rng, (ring.num_limbs, l, 70, 130))
                          % ring.q.reshape(-1, 1, 1, 1))
    want = fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc, lhs_dig=lhs_dig,
                                 noise_bound=bound, post=post)
    move = lambda t: None if t is None else t.to(cuda_device)
    got = fm.matmul_fold_scaled(None, move(band), ring, noise=move(noise),
                                encode=None if enc is None else tuple(map(move, enc)),
                                lhs_dig=move(lhs_dig), encode32=encode == "enc32",
                                noise_bound=bound, post=move(post))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("moduli,l,jr,lo,hi", [(TOY, 8, 1, 20, 90), (CHAIN_61X17, 16, 2, 0, 0)])
def test_masked_post_equals_plain_twin(cuda_device, moduli, l, jr, lo, hi):
    """The masked form with ``post=``: post on every row, the noise and the
    encode on [lo, hi) only."""
    ring, lhs_dig, band, _, bound, enc = operands(moduli, jr, "enc64", 33, m=70, k=9, n=130,
                                                  l=l)
    post = u64.u64_tensor(rand_u64(np.random.default_rng(34), (ring.num_limbs, l, 70, 130))
                          % ring.q.reshape(-1, 1, 1, 1))
    g = ((0xDEADBEEF, 0x12345678, 7, lo, hi, 5), jr, bound, "tfry")
    want = fm.matmul_fold_scaled(None, band, ring, encode=enc, lhs_dig=lhs_dig, gen_noise=g,
                                 post=post)
    move = lambda t: t.to(cuda_device)
    before = fm.fused_scaled_noise_matmul.masked_launches
    got = fm.matmul_fold_scaled(None, move(band), ring, encode=tuple(map(move, enc)),
                                lhs_dig=move(lhs_dig), gen_noise=g, post=move(post))
    torch.cuda.synchronize()
    assert fm.fused_scaled_noise_matmul.masked_launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("moduli,l,m,k,n", [
    (TOY, 8, 70, 33, 130), (TOY, 8, 128, 64, 64), (BIG, 8, 65, 17, 33),
    (CHAIN_61X17, 16, 40, 48, 31), (generate_ntt_primes(31, 1, 8), 8, 64, 5, 64),
])
def test_banded_kernel_equals_plain_twin(cuda_device, moduli, l, m, k, n):
    """Kernel 2 against ``modmat.matmul_channels``: C = 9 and 15 columns
    (and 7, a 31-bit modulus), m and n off its 64 x 32 tile, k multiples of
    16 and odd k."""
    ring = RingPlan(moduli, l)
    rng = np.random.default_rng(31)
    qs = ring.q.reshape(-1, 1, 1, 1)
    a = u64.u64_tensor(rand_u64(rng, (ring.num_limbs, l, m, k)) % qs)
    b = u64.u64_tensor(rand_u64(rng, (ring.num_limbs, l, k, n)) % qs)
    want = fm.matmul_channels_fused(a, b, ring)
    assert torch.equal(want, modmat.matmul_channels(a, b, ring))
    before = fm.banded_matmul.launches
    got = fm.matmul_fold_auto(a.to(cuda_device), b.to(cuda_device), ring)
    torch.cuda.synchronize()
    assert fm.banded_matmul.launches == before + 1
    assert torch.equal(got.cpu(), want)


# (m, k, n): m and n on, below and off kernel 2's 64 x 32 tile, k below
# one 64-byte stage (1, 17, 40) and many stages (512)
BANDED_EDGES = [(1, 1, 63), (63, 17, 1000), (65, 40, 1), (1000, 512, 65), (65, 512, 1000),
                (1000, 40, 63)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k", [(1, 1), (63, 17), (65, 40), (130, 512), (1000, 100)])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nd", range(1, 9))
def test_digit_planes_kernel_equals_plain_twin(cuda_device, nd, transpose, rows, k):
    """Kernel 2's operand layout kernel against its twin at every digit
    count, both operand orientations (the rhs read transposed) and rows and
    k off its 64 x 64 tile: every byte of the storage, pads included."""
    ring = RingPlan(CHAIN_BY_ND[nd], 8)
    rng = np.random.default_rng(50 + nd)
    q = ring.q.reshape(-1, 1, 1, 1)
    shape = (k, rows) if transpose else (rows, k)
    x = u64.u64_tensor(rand_u64(rng, (ring.num_limbs, 8, *shape)) % q, cuda_device)
    x[:, :, 0, 0] = torch.from_numpy(ring.q.astype(np.int64) - 1).to(cuda_device)[:, None]
    x = x.reshape(-1, *shape)
    before = fm.digit_planes_kpacked.launches
    got = fm.digit_planes_kpacked(x, nd, transpose)
    want = fm.digit_planes_kpacked_plain(x, nd, transpose)
    torch.cuda.synchronize()
    assert fm.digit_planes_kpacked.launches == before + 1
    store = lambda p: torch.as_strided(p, (*p.shape[:-1], p.stride(-2)), p.stride())
    assert got.stride() == want.stride() and torch.equal(store(got), store(want))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", BANDED_EDGES)
@pytest.mark.parametrize("nd", range(1, 9))
def test_banded_kernel_edges_equal_plain_twin(cuda_device, nd, m, k, n):
    """Kernel 2 on wgmma at every digit count and the edge shapes: the
    launch on the k-packed digit planes against its contract's twin
    ``banded_matmul_plain``, and the entry ``matmul_fold_auto`` against
    ``modmat.matmul_channels``, residues with 0 and q - 1 among them."""
    ring = RingPlan(CHAIN_BY_ND[nd], 8)
    assert ring.num_digits == nd
    rng = np.random.default_rng(40 + nd)
    L = ring.num_limbs
    q = ring.q.reshape(-1, 1, 1, 1)
    a = u64.u64_tensor(rand_u64(rng, (L, 8, m, k)) % q, cuda_device)
    b = u64.u64_tensor(rand_u64(rng, (L, 8, k, n)) % q, cuda_device)
    a[:, :, 0, 0] = torch.from_numpy(ring.q.astype(np.int64) - 1).to(cuda_device)[:, None]
    b[:, :, 0, 0] = 0
    ap = fm.digit_planes_kpacked(a.reshape(L * 8, m, k), nd)
    bp = fm.digit_planes_kpacked(b.reshape(L * 8, k, n), nd, transpose=True)
    tables = fm._banded_tables(ring, 8, cuda_device)
    before = fm.banded_matmul.launches
    got = fm.banded_matmul(ap, bp, tables)
    torch.cuda.synchronize()
    assert torch.equal(got, fm.banded_matmul_plain(ap, bp, tables))
    got = fm.matmul_fold_auto(a, b, ring)
    torch.cuda.synchronize()
    assert fm.banded_matmul.launches == before + 2
    assert torch.equal(got, modmat.matmul_channels(a, b, ring))


@pytest.mark.cuda
def test_banded_and_masked_failures_raise(cuda_device, monkeypatch):
    """No fallback: refused launches of kernel 2, of its layout kernel and of
    the masked form raise, and so do digit planes that are not k-packed."""
    ring = RingPlan(TOY, 8)
    a = torch.zeros((2, 8, 4, 3), dtype=torch.int64, device=cuda_device)
    b = torch.zeros((2, 8, 3, 5), dtype=torch.int64, device=cuda_device)
    planes = torch.zeros((16, 5, 4, 3), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="16-byte strides"):     # rows not k-packed
        fm.banded_matmul(planes, planes, fm._banded_tables(ring, 8, cuda_device))
    monkeypatch.setattr(fm, "_banded_fn", lambda: (lambda *args: 700))
    with pytest.raises(RuntimeError, match="launch failed"):
        fm.matmul_channels_fused(a, b, ring)
    monkeypatch.setattr(fm, "_digits_fn", lambda: (lambda *args: 700))
    with pytest.raises(RuntimeError, match="launch failed"):
        fm.matmul_channels_fused(a, b, ring)
    monkeypatch.setattr(fm, "_kernel_fn", lambda symbol: (lambda *args: 700))
    _, lhs_dig, band, _, _, _ = operands(TOY, 1, None, 32, m=8, k=4, n=8)
    with pytest.raises(RuntimeError, match="launch failed"):
        fm.matmul_fold_scaled(None, band.to(cuda_device), ring, lhs_dig=lhs_dig.to(cuda_device),
                              gen_noise=((1, 2, 0, 0, 4, 0), 1, 50, "tfry"))


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["kernel", "v3k"])
def test_parallel_backends_on_the_card_equal_cpu(cuda_device, stream):
    """Every backend with ``cuda:0`` repeated against the same backend on the
    CPU and the single-device encryption: the (2, 2) mesh, (1, 1) with
    ``_force_masked``, the dealer split, the limb split and a grid; the masked
    form launches on every v3k kdim > 1 or forced shard and nowhere else."""
    import pvw_tpu_torch as P
    import pvw_tpu_torch.parallel as TP
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings

    moduli = generate_ntt_primes(55, 4, 8)
    params = P.PvwParameters(8, 8, 8, moduli, 0.5, 50, 2000)
    sc = np.arange(64, dtype=np.uint64).reshape(8, 8) * np.uint64(977)
    sc[0, 1] = (1 << 64) - 1
    key = R.key(6)
    settings.noise_stream = stream
    try:
        out = {}
        for dev in (torch.device("cpu"), cuda_device):
            crs = P.PvwCrs.new(params, R.fold_in(key, 1), device=dev)
            parties = [P.Party.new(i, params, R.fold_in(key, 10 + i), device=dev)
                       for i in range(8)]
            gpk = P.GlobalPublicKey(crs)
            gpk.generate_all_party_keys(parties, R.fold_in(key, 2))
            k5 = R.fold_in(key, 5)
            before = fm.fused_scaled_noise_matmul.masked_launches
            cts = {"single": P.encrypt_batch(sc, gpk, k5),
                   "mesh": TP.encrypt_batch_sharded(sc, gpk, k5, TP.make_mesh([dev] * 4)),
                   "forced": TP.encrypt_batch_sharded(sc, gpk, k5, TP.make_mesh([dev], kdim=1),
                                                      _force_masked=True),
                   "limb": TP.encrypt_batch_limb_parallel(sc, gpk, k5, [dev] * 4).gather(),
                   "grid": TP.encrypt_batch_grid(sc, gpk, k5, [dev] * 4, kdim=2).gather()}
            if stream == "v3k":
                cts["dealer"] = TP.encrypt_batch_data_parallel(sc, gpk, k5, [dev] * 3).gather()
            masked = fm.fused_scaled_noise_matmul.masked_launches - before
            # c1 on recv row 0's shards, c2 on every shard: (2, 2) 2 + 4, forced
            # 1 + 1, grid 2 x ((1, 2): 2 + 2)
            if dev.type == "cuda":
                assert masked == (6 + 2 + 8 if stream == "v3k" else 0)
            out[dev.type] = {name: (ct.c1.residues_np(), ct.c2.residues_np())
                             for name, ct in cts.items()}
            shares = TP.decrypt_party_shares_sharded(cts["mesh"], parties[3].secret_key, 3,
                                                     TP.make_mesh([dev] * 4))
            assert shares == [0 if v == (1 << 64) - 1 else int(v) for v in sc[:, 3]]
        for name, (c1, c2) in out["cuda"].items():
            for got, cpu, single in zip((c1, c2), out["cpu"][name], out["cuda"]["single"]):
                np.testing.assert_array_equal(got, cpu)
                np.testing.assert_array_equal(got, single)
    finally:
        del settings.noise_stream


@pytest.mark.cuda
@pytest.mark.parametrize("stream", ["kernel", "v3k"])
def test_parallel_backends_over_distinct_cards(stream):
    """Every backend over every visible card, each shard on its own device
    (the defaults: ``make_mesh()`` and ``devices=None``), against the
    single-device encryption on ``cuda:0``; sharded, limb-parallel and grid
    decryption exact, each decoding on its shards' cards."""
    import pvw_tpu_torch as P
    import pvw_tpu_torch.parallel as TP
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least two CUDA cards")
    cards = torch.cuda.device_count()
    moduli = generate_ntt_primes(55, 4, 8)
    params = P.PvwParameters(8, 8, 8, moduli, 0.5, 50, 2000)
    sc = np.arange(64, dtype=np.uint64).reshape(8, 8) * np.uint64(977)
    key = R.key(7)
    dev0 = torch.device("cuda", 0)
    settings.noise_stream = stream
    try:
        crs = P.PvwCrs.new(params, R.fold_in(key, 1), device=dev0)
        parties = [P.Party.new(i, params, R.fold_in(key, 10 + i), device=dev0)
                   for i in range(8)]
        gpk = P.GlobalPublicKey(crs)
        gpk.generate_all_party_keys(parties, R.fold_in(key, 2))
        k5 = R.fold_in(key, 5)
        mesh = TP.make_mesh()
        assert {d.index for row in mesh.devices for d in row} == set(range(cards))
        limb = TP.encrypt_batch_limb_parallel(sc, gpk, k5)
        cts = {"single": P.encrypt_batch(sc, gpk, k5),
               "mesh": TP.encrypt_batch_sharded(sc, gpk, k5, mesh), "limb": limb.gather()}
        grid = TP.encrypt_batch_grid(sc, gpk, k5) if cards % 2 == 0 else None
        if grid is not None:
            cts["grid"] = grid.gather()
        if stream == "v3k":
            cts["dealer"] = TP.encrypt_batch_data_parallel(sc, gpk, k5).gather()
        want = (cts["single"].c1.residues_np(), cts["single"].c2.residues_np())
        for name, ct in cts.items():
            np.testing.assert_array_equal(ct.c1.residues_np(), want[0], err_msg=name)
            np.testing.assert_array_equal(ct.c2.residues_np(), want[1], err_msg=name)
        sk, want_shares = parties[3].secret_key, [int(v) for v in sc[:, 3]]
        assert TP.decrypt_party_shares_sharded(cts["mesh"], sk, 3, mesh) == want_shares
        assert TP.decrypt_party_shares_limb_parallel(limb, sk, 3) == want_shares
        if grid is not None:
            assert TP.decrypt_party_shares_grid(grid, sk, 3) == want_shares
    finally:
        del settings.noise_stream


# --------------------------------------------------------------------------
# kernels 1 and 3 on wgmma with a TMA ring, the k-packed band
# --------------------------------------------------------------------------

# (m, k*nd, n): m and n on, below and off the 64 x 32 tile; k*nd below one
# 128-byte stage (40) and above the deepest ring (1280: more k stages than
# ring slots, several tiles a consumer)
EDGE_SHAPES = [(1, 40, 63), (63, 1280, 1000), (65, 1280, 1), (1000, 40, 65),
               (1000, 1280, 1000)]
V3K = (0xDEADBEEF, 0x12345678)


def _edge_operands(nd, m, kd, n, dev, seed, jr=1):
    """Random operands made on the card, l = 8, k*nd near ``kd``: residues
    a [L, 8, m, k] and b [L, 8, k, n], the lhs digit planes, the band of b
    (k-packed), noise planes of jr digits (bound 50 or 2000) and the 64-bit
    encode."""
    ring = RingPlan(CHAIN_BY_ND[nd], 8)
    k = max(1, round(kd / nd))
    rng = np.random.default_rng(seed)
    L = ring.num_limbs
    q = ring.q.reshape(L, 1, 1, 1)
    a = u64.u64_tensor(rand_u64(rng, (L, 8, m, k)) % q, dev)
    b = u64.u64_tensor(rand_u64(rng, (L, 8, k, n)) % q, dev)
    bound = 50 if jr == 1 else 2000
    ev = torch.from_numpy(rng.integers(-bound, bound + 1, (m, n, 8)).astype(np.int32))
    noise = ntt._digit_planes(ev.to(dev), jr)
    sc = rand_u64(rng, (m, n))
    sc.flat[:3] = [0, 1 << 63, (1 << 64) - 1]          # m * n >= 3 at every edge shape
    g = rand_u64(rng, (L, 8)) % ring.q[:, None]
    gs = np.array([[(int(g[i, s]) << 64) // qi for s in range(8)]
                   for i, qi in enumerate(ring.moduli)], object)
    wrap = np.array([[pow(2, 64, qi) * int(g[i, s]) % qi for s in range(8)]
                     for i, qi in enumerate(ring.moduli)], np.uint64)
    etab = fm.encode_tab(g, (gs & 0xFFFFFFFFFFFFFFFF).astype(np.uint64), wrap)
    enc = (u64.u64_tensor(sc, dev), u64.u64_tensor(etab, dev))
    lhs_dig = modmat.digits(a, nd).reshape(L, 8, m, k * nd)
    return ring, a, b, lhs_dig, modmat.prescale_digits_band(b, ring), noise, bound, enc


@pytest.mark.cuda
@pytest.mark.parametrize("m,kd,n", EDGE_SHAPES)
@pytest.mark.parametrize("nd", range(1, 9))
def test_wgmma_kernel_edges_equal_plain_twin(cuda_device, nd, m, kd, n):
    """Kernel 1 at every digit count and the edge shapes, noise rows (jr =
    2 at even nd) and the 64-bit encode: the k-packed band taken as it
    lies, an n-major copy relaid once (counted), the same residues as the
    twin on the card."""
    jr = 2 - nd % 2
    ring, _, _, lhs_dig, band, noise, bound, enc = _edge_operands(nd, m, kd, n, cuda_device,
                                                                  60 + nd, jr)
    want = fm.matmul_fold_scaled_plain(None, band, ring, noise=noise, encode=enc,
                                       lhs_dig=lhs_dig)
    before = fm.band_relayouts
    for b in (band, band.contiguous()):
        got = fm.matmul_fold_scaled(None, b, ring, noise=noise, encode=enc, lhs_dig=lhs_dig,
                                    noise_bound=bound)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    # the copy is relaid unless it lies k-packed already (n = 1, 16-byte rows)
    assert fm.band_relayouts == before + (not modmat.k_rows_ok(band.contiguous()
                                                               .transpose(-1, -2)))


@pytest.mark.cuda
@pytest.mark.parametrize("m,kd,n", EDGE_SHAPES[:4])
@pytest.mark.parametrize("nd", [1, 3, 5, 8])
def test_wgmma_swapped_edges_equal_plain_twin(cuda_device, nd, m, kd, n):
    """Kernel 1's swapped form (A = the rhs digits, 64 dealers a tile; B =
    the scaled lhs planes, 32 receivers a plane; the transposed tile
    stored) at the edge shapes."""
    ring, a, b, _, _, noise, bound, enc = _edge_operands(nd, m, kd, n, cuda_device, 70 + nd)
    planes = modmat.lhs_scaled_planes(a.permute(2, 3, 0, 1), ring)
    rd = modmat.rhs_digit_cols(b, ring)
    want = fm.matmul_fold_swapped_plain(planes, rd, ring, noise=noise, encode=enc)
    before = fm.fused_scaled_noise_matmul_swapped.launches
    got = fm.matmul_fold_swapped(planes, rd, ring, noise=noise, encode=enc, noise_bound=bound)
    torch.cuda.synchronize()
    assert fm.fused_scaled_noise_matmul_swapped.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("m,kd,n,lo,hi", [(65, 1280, 1000, 10, 50), (1000, 40, 63, 300, 1000),
                                          (1000, 1280, 1000, 0, 1000)])
@pytest.mark.parametrize("nd", [3, 8])
def test_wgmma_masked_post_edges_equal_plain_twin(cuda_device, nd, m, kd, n, lo, hi):
    """Kernel 1's masked form with ``post=`` at the edge shapes: the
    generator's masked planes, the encode on the rows [lo, hi), post on
    every row."""
    ring, _, _, lhs_dig, band, _, bound, enc = _edge_operands(nd, m, kd, n, cuda_device,
                                                              80 + nd)
    q = ring.table("q", cuda_device).reshape(-1, 1, 1, 1)
    post = u64.u64_tensor(rand_u64(np.random.default_rng(nd), (ring.num_limbs, 8, m, n)),
                          cuda_device) % q
    planes = fm.v3k_noise_planes_plain(*V3K, 0, m, n, 8, bound, 3, cuda_device,
                                       mask=(lo, hi))
    want = fm.matmul_fold_scaled_plain(None, band, ring, noise=planes, encode=enc,
                                       lhs_dig=lhs_dig, post=post, mask=(0, lo, hi))
    before = fm.fused_scaled_noise_matmul.masked_launches
    got = fm.matmul_fold_scaled(None, band, ring, encode=enc, lhs_dig=lhs_dig, post=post,
                                gen_noise=((*V3K, 0, lo, hi, 3), 1, bound, "tfry"))
    torch.cuda.synchronize()
    assert fm.fused_scaled_noise_matmul.masked_launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("noise_kind", ["planes", "v3k"])
@pytest.mark.parametrize("m,kd,n", [(63, 1280, 1000), (1000, 40, 65), (1, 1280, 63)])
@pytest.mark.parametrize("nd", range(1, 9))
def test_wgmma_pipelined_edges_equal_plain_twin(cuda_device, nd, m, kd, n, noise_kind):
    """Kernel 3 (two consumers in ping-pong over the channels) at every
    digit count and the edge shapes, with input planes or in-kernel v3k
    (offsets whose counters wrap), the 64-bit encode."""
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import tfry

    jr = 2 - nd % 2
    ring, _, _, lhs_dig, band, noise, bound, enc = _edge_operands(nd, m, kd, n, cuda_device,
                                                                  90 + nd, jr)
    gen = None
    if noise_kind == "v3k":
        offs = ((1 << 32) - 3, 1 << 31)
        gen = ((*V3K, *offs), jr, bound, "tfry")
        noise = tfry.v3k_noise_digit_planes(*V3K, offs[0], m, n, 8, bound, offs[1],
                                            cuda_device)
    want = fm.matmul_fold_scaled_plain(None, band, ring, noise=noise, encode=enc,
                                       lhs_dig=lhs_dig)
    before = fm.fused_pipelined_matmul.launches
    settings.pipeline_fold = True
    try:
        got = fm.matmul_fold_scaled(None, band, ring, noise=None if gen else noise, encode=enc,
                                    lhs_dig=lhs_dig, noise_bound=bound, gen_noise=gen)
    finally:
        del settings.pipeline_fold
    torch.cuda.synchronize()
    assert fm.fused_pipelined_matmul.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_wgmma_kernels_on_another_card(cuda_device):
    """The tensor maps are encoded and the kernels launched with the
    operands' card current: kernels 1 (banded, swapped), 3 and 2 on
    cuda:1."""
    from pvw_tpu_torch.config import settings

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda:1")
    ring, a, b, lhs_dig, band, noise, bound, enc = _edge_operands(8, 65, 1280, 100, dev, 99)
    want = fm.matmul_fold_scaled_plain(None, band, ring, noise=noise, encode=enc,
                                       lhs_dig=lhs_dig)
    got = [fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc, lhs_dig=lhs_dig,
                                 noise_bound=bound),
           fm.matmul_fold_swapped(modmat.lhs_scaled_planes(a.permute(2, 3, 0, 1), ring),
                                  modmat.rhs_digit_cols(b, ring), ring, noise=noise,
                                  encode=enc, noise_bound=bound)]
    settings.pipeline_fold = True
    try:
        got.append(fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc,
                                         lhs_dig=lhs_dig, noise_bound=bound))
    finally:
        del settings.pipeline_fold
    banded = fm.matmul_fold_auto(a, b, ring)
    torch.cuda.synchronize(dev)
    assert all(g.device == dev and torch.equal(g, want) for g in got)
    assert banded.device == dev and torch.equal(banded, modmat.matmul_channels(a, b, ring))


# --------------------------------------------------------------------------
# the probes' kernels (pvw_tpu_torch/benchmarks): fold_only, int32_peak and
# the three dot-structure layouts
# --------------------------------------------------------------------------

# two limbs of each digit count the fold kernel is held at
FOLD_MODULI = {5: TOY, 7: (0x3FFFFFFFFFFF01, 0x3FFFFFFFFFFE81),
               8: (0x1FFFFFFFFFFFFFE1, 0x1FFFFFFFFFFFFCE1)}


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(1, 1), (1, 300), (3, 255), (17, 257), (64, 1000)])
@pytest.mark.parametrize("nd", [5, 7, 8])
def test_fold_only_kernel_equals_plain_twin(cuda_device, nd, m, n):
    """Pass 2 of the two-pass probe over int32 columns across the whole
    int32 range (both ends among them), n off the kernel's 256-column
    block, m = 1: every residue, one launch."""
    from pvw_tpu_torch.benchmarks import probe_twopass as tp

    ring = RingPlan(FOLD_MODULI[nd], 8)
    assert ring.num_digits == nd
    rng = np.random.default_rng(nd * m + n)
    cols = rng.integers(-(1 << 31), 1 << 31, (16, m, nd, n), dtype=np.int64)
    cols[0, 0, :, 0], cols[-1, -1, :, -1] = -(1 << 31), (1 << 31) - 1
    cols = torch.from_numpy(cols.astype(np.int32)).to(cuda_device)
    before = tp.fold_only.launches
    got = tp.fold_only(cols, ring)
    torch.cuda.synchronize()
    assert tp.fold_only.launches == before + 1
    assert torch.equal(got, tp.fold_only_plain(cols, ring))


@pytest.mark.cuda
@pytest.mark.parametrize("nd,m,k,n", [(5, 17, 8, 40), (8, 33, 4, 64), (8, 20, 3, 24)])
def test_two_pass_equals_kernel1_bare_on_the_card(cuda_device, nd, m, k, n):
    """The two-pass probe's check on the card: ``torch._int_mm`` columns
    (no copy of a k-packed band and 16-byte lhs rows with kd a multiple of
    16; one copy of each, counted, where it is not) folded by the kernel
    equal kernel 1's bare product. ``torch._int_mm`` takes m > 16 and kd
    and nd*n multiples of 8."""
    from pvw_tpu_torch.benchmarks import probe_twopass as tp

    ring = RingPlan(TOY if nd == 5 else BIG, 8)
    lhs_dig, band = tp.operands(ring, m, k, n, nd + m, cuda_device)
    before = tp.pass1_dot.relayouts
    res = tp.run(lhs_dig, band, ring)
    torch.cuda.synchronize()
    assert res["equal"]
    assert tp.pass1_dot.relayouts == before + 2 * ((k * nd) % 16 != 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (7, 33), (512, 1024)])
@pytest.mark.parametrize("iters", [0, 20, 300, 512])
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_int32_peak_kernel_equals_plain_twin(cuda_device, shape, iters, lanes):
    """The int32 peak over values whose products wrap, with whole blocks of
    256 multiply-adds (300, 512), a remainder (20, 300 at some lanes) and
    none (0): every element."""
    from pvw_tpu_torch.benchmarks import fold_roofline as fr

    rng = np.random.default_rng(iters + lanes)
    x = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
                         .astype(np.int32)).to(cuda_device)
    before = fr.int32_peak.launches
    got = fr.int32_peak(x, iters, lanes)
    torch.cuda.synchronize()
    assert fr.int32_peak.launches == before + 1
    assert torch.equal(got, fr.int32_peak_plain(x, iters, lanes))


@pytest.mark.cuda
def test_int32_peak_time_is_linear_in_its_work(cuda_device):
    """Twice the multiply-adds take 1.9-2.1x the time (CUDA events, medians
    of 5): the compiler folded none of them."""
    from pvw_tpu_torch.benchmarks import fold_roofline as fr

    r = fr.measure(fr.tile(cuda_device), iters_inner=16384)
    assert 1.9 <= r["linearity"] <= 2.1, r


@pytest.mark.cuda
def test_probe_kernels_refuse_what_they_lack(cuda_device):
    from pvw_tpu_torch.benchmarks import fold_roofline as fr
    from pvw_tpu_torch.benchmarks import probe_dot_structure as ds

    x = torch.zeros((4, 4), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="lanes"):
        fr.int32_peak(x, 16, 3)
    with pytest.raises(ValueError, match="expected contiguous"):
        fr.int32_peak(x.to(torch.int64), 16)
    lhs = torch.zeros((2, 70, 64), dtype=torch.int8, device=cuda_device)
    band = torch.zeros((2, 5, 64, 96), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of 32"):
        ds.dot_structure(lhs, ds.band_wide(band, 48), "wide", 48, 5)


DOT_EDGES = [(1, 64, 32), (70, 40, 96), (65, 1280, 64), (200, 136, 160)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,kd,d", DOT_EDGES)
@pytest.mark.parametrize("nd", [5, 7, 8])
@pytest.mark.parametrize("layout", ["planes", "one_dot", "wide"])
def test_dot_structure_kernel_equals_plain_twin(cuda_device, layout, nd, m, kd, d):
    """Each layout at the edge shapes (m = 1 and off the 64-row tile, kd
    off the 128-byte stage and the 16-byte pitch; D a multiple of the wide
    layout's 32-column blocks, off the 64-column pair of tiles), the whole
    int8 range: every output, one launch of that layout; the band in the
    JAX memory layout relaid once, a laid one not again."""
    from pvw_tpu_torch.benchmarks import probe_dot_structure as ds

    rng = np.random.default_rng(m + kd + nd)
    lhs = modmat.k_rows(torch.from_numpy(rng.integers(-128, 128, (3, m, kd)).astype(np.int8))
                        .to(cuda_device))
    band = torch.from_numpy(rng.integers(-128, 128, (3, nd, kd, d)).astype(np.int8))
    bx = ds.band_layout(band, layout, 32).to(cuda_device)
    want = ds.dot_structure_plain(lhs, bx, layout, 32, nd)
    relaid, before = ds.dot_structure.relayouts, getattr(ds.dot_structure,
                                                         f"{layout}_launches")
    laid = ds.dot_operand(bx, layout)
    got = ds.dot_structure(lhs, laid, layout, 32, nd)
    torch.cuda.synchronize()
    assert getattr(ds.dot_structure, f"{layout}_launches") == before + 1
    assert ds.dot_structure.relayouts == relaid + 1
    assert torch.equal(got, want)
    assert torch.equal(ds.dot_structure(lhs, bx, layout, 32, nd), want)
    assert ds.dot_structure.relayouts == relaid + 2


# --------------------------------------------------------------------------
# the device decode (plain torch, no kernel of its own) on the card
# --------------------------------------------------------------------------

def decode_params(moduli, l):
    from pvw_tpu_torch.params.parameters import PvwParameters, PvwParametersBuilder

    b1, b2 = PvwParameters.suggest_error_bounds(4, 16, l, moduli, 0.5)
    return (PvwParametersBuilder().set_parties(4).set_dimension(16).set_l(l)
            .set_moduli(moduli).set_secret_variance(0.5).set_error_bounds_u32(b1, b2)
            .build())


@pytest.mark.cuda
@pytest.mark.parametrize("moduli,l", [(TOY, 8), (CHAIN_61X17, 16),
                                      (tuple(generate_ntt_primes(55, 4, 8)), 8)],
                         ids=["toy", "config4", "reference"])
def test_device_decode_on_card_equals_python_decode(cuda_device, moduli, l):
    """``decode_residues`` on the card against ``decode_scalar_pvw_rns``,
    every message: encodings -(v Δ^j + e_j) of messages at the clamp
    (±1000, ±1001), past u64 and random, rows lifting to q//2 and q//2 + 1,
    a zero row, uniform residues; only the [d] messages come back."""
    from pvw_tpu_torch.crypto import device_decode
    from pvw_tpu_torch.crypto.decryption import decode_scalar_pvw_rns

    p = decode_params(moduli, l)
    q, delta = p.q_total(), p.delta()
    rng = np.random.default_rng(l)
    rows = [[q // 2] * l, [q // 2 + 1] * l, [0] * l]
    for v in [-1000, 1000, -1001, 1001, 1 << 64, (1 << 64) - 1] + \
            [int(x) for x in rng.integers(0, 1 << 63, 20)]:
        e = rng.integers(-(delta // 4), delta // 4 + 1, size=l).tolist()
        rows.append([(-((v % q) * delta ** j + e[j])) % q for j in range(l)])
    res = np.stack([rng.integers(0, m, size=(64, l), dtype=np.uint64) for m in moduli], 1)
    for r, coeffs in enumerate(rows):
        res[r] = p.ring.residues_from_int_coeffs(coeffs)
    before = device_decode.decode_residues.calls
    out = device_decode.decode_residues(device_decode.get_plan(p),
                                        u64.u64_tensor(res, cuda_device))
    assert out.device.type == "cuda" and out.shape == (64,)
    assert device_decode.decode_residues.calls == before + 1
    got = [int(v) for v in u64.u64_numpy(out)]
    assert got == [decode_scalar_pvw_rns(r, p) for r in res]
    assert got[3:7] == [0, 1000, 0, 1001] and got[7] == 0


def small_system_on_card(dev, n=4, k=8):
    """A toy-chain system on the card: CRS, batch keygen, one key re-made
    with its errors recorded, and a batch of n dealers."""
    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R

    b1, b2 = P.PvwParameters.suggest_error_bounds(n, k, 8, TOY, 0.5)
    params = (P.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(8)
              .set_moduli(TOY).set_secret_variance(0.5).set_error_bounds_u32(b1, b2).build())
    key = R.key(21)
    crs = P.PvwCrs.new(params, R.fold_in(key, 0), device=dev)
    parties = [P.Party.new(i, params, R.fold_in(key, 100 + i), device=dev) for i in range(n)]
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, R.fold_in(key, 1))
    gpk.generate_and_add_with_errors(1, parties[1].secret_key, R.fold_in(key, 2))
    shares = np.arange(n * n, dtype=np.uint64).reshape(n, n) * 977 + 5
    ct = P.encrypt_all_party_shares_batched(shares, gpk, R.fold_in(key, 3))
    return P, params, parties, gpk, shares, ct


@pytest.mark.cuda
def test_serialization_round_trip_on_card(cuda_device):
    """Every type's bytes, loaded back on the card (and on the host), write
    the same bytes again; the loaded ciphertext and keys decrypt."""
    P, params, parties, gpk, shares, ct = small_system_on_card(cuda_device)
    dealer0 = P.PvwCiphertext(P.Poly(ct.c1.res[:, 0], ct.c1.rep, params.ring),
                              P.Poly(ct.c2.res[:, 0], ct.c2.rep, params.ring), params)
    for obj in (params, gpk.crs.matrix[0], parties[2].secret_key, gpk.crs,
                gpk.get_public_key(1), gpk, ct, dealer0):
        blob = obj.to_bytes()
        for device in ("cuda", "cpu"):
            loaded = (type(obj).from_bytes(blob) if isinstance(obj, (P.PvwParameters,
                                                                      P.SecretKey))
                      else type(obj).from_bytes(blob, device=device))
            assert loaded.to_bytes() == blob
    loaded = P.GlobalPublicKey.from_bytes(gpk.to_bytes())
    assert loaded.matrix.res.device.type == "cuda" and loaded.crs.device.type == "cuda"
    assert torch.equal(loaded.get_party_errors(1).res, gpk.get_party_errors(1).res)
    lct = P.PvwCiphertext.from_bytes(ct.to_bytes())
    assert lct.c1.res.device.type == "cuda"
    sk = P.SecretKey.from_bytes(parties[3].secret_key.to_bytes())
    assert P.decrypt_party_shares(lct, sk, 3) == [int(v) for v in shares[:, 3]]


@pytest.mark.cuda
def test_host_route_from_card_ciphertexts(cuda_device):
    """Card-resident ciphertexts below the crossover decrypt in the host
    engine by default (no device decode), equal to the device route."""
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.crypto import decryption, device_decode

    P, params, parties, gpk, shares, ct = small_system_on_card(cuda_device)
    before = (decryption.engine_calls.host, device_decode.decode_residues.calls)
    got = P.decrypt_party_shares(ct, parties[2].secret_key, 2)
    sub = P.decrypt_valid_shares(ct, [0, 3], 2, parties[2].secret_key, 2)
    one = P.decrypt_party_value(P.encrypt(shares[0], gpk, R.key(4)), parties[1].secret_key, 1)
    assert (decryption.engine_calls.host, device_decode.decode_residues.calls) == \
        (before[0] + 3, before[1])
    settings.decode_mode = "device"
    try:
        assert P.decrypt_party_shares(ct, parties[2].secret_key, 2) == got
        assert device_decode.decode_residues.calls == before[1] + 1
    finally:
        del settings.decode_mode
    assert got == [int(v) for v in shares[:, 2]]
    assert sub == [(0, int(shares[0, 2])), (3, int(shares[3, 2]))]
    assert one == int(shares[0, 1])
