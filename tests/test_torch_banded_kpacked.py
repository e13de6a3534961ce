"""Kernel 2's operand layout and contract in the port, on the CPU.

``fused_modmat.digit_planes_kpacked`` lays the residues' balanced digits
out as kernel 2 (``csrc/banded_matmul.cu``) reads them through TMA: int8
planes [CH, nd, rows, k] on rows of a 16-byte pitch, zero pads. It is held
against ``u64.to_signed_digits`` at every digit count, with residues at 0,
q - 1 and bytes at the carry edge (0x7F, 0x80, 0xFF). The kernel's plain
twin ``banded_matmul_plain`` (the nd^2 digit-pair products into 2nd - 1
columns, then the grouped fold) on those planes is held against the Pallas
kernel through ``matmul_channels_pallas`` in interpret mode and against
``pvw_tpu.ops.modmat.matmul_channels_banded``. Residues are canonical, so
the tolerance is 0: byte equality. The launch tables of kernels 2 and 4
are cached per ring: equal to fresh ones, built once. The CUDA kernel is
held against the twin in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pvw_tpu.ops import modmat as jmm
from pvw_tpu.ops import pallas_modmat as jpm
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.ring import RingPlan as JRing
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import modmat as tmm
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import RingPlan as TRing
from pvw_tpu_torch.utils.intmath import generate_ntt_primes

# a two-limb chain of each digit count nd = 1..8 (l = 8)
CHAIN_BY_ND = {1: (97, 113), **{nd: generate_ntt_primes(bits, 2, 8) for nd, bits in
                                 ((2, 14), (3, 22), (4, 30), (5, 38), (6, 46), (7, 54),
                                  (8, 61))}}
TOY = (0xFFFFC4001, 0x1FFFFE0001)                 # nd = 5
BIG = (0x800000022A0001, 0x800000021A0001)        # nd = 8


def edge_residues(moduli, shape, seed):
    """Canonical residues [L, *shape]: random ones, 0, q - 1, and values
    whose bytes are 0x7F, 0x80 or 0xFF (each balanced digit's carry edge),
    reduced mod q."""
    rng = np.random.default_rng(seed)
    qs = np.array(moduli, np.uint64).reshape(-1, *(1,) * len(shape))
    x = rng.integers(0, 1 << 62, (len(moduli), *shape), dtype=np.uint64) % qs
    edge = np.zeros(x.shape, np.uint64)
    for b in range(8):
        byte = rng.choice(np.array([0x7F, 0x80, 0xFF, 0x00], np.uint64), x.shape)
        edge |= byte << np.uint64(8 * b)
    pick = rng.random(x.shape) < 0.5
    x = np.where(pick, edge % qs, x)
    flat = x.reshape(len(moduli), -1)
    flat[:, 0] = 0
    flat[:, 1] = qs.reshape(-1) - 1
    flat[:, 2] = 0x80 % qs.reshape(-1)
    return flat.reshape(x.shape)


@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("nd", range(1, 9))
def test_digit_planes_kpacked_equal_signed_digits(nd, transpose):
    """The planes hold ``to_signed_digits`` permuted to [CH, nd, rows, k]
    (the rhs [CH, k, rows] taken transposed), on rows of a 16-byte pitch
    with zero pads."""
    ring = TRing(CHAIN_BY_ND[nd], 8)
    assert ring.num_digits == nd
    rows, k = 5, 21
    shape = (8, k, rows) if transpose else (8, rows, k)
    x = tu.u64_tensor(edge_residues(ring.moduli, shape, nd)).reshape(-1, *shape[1:])
    got = tfm.digit_planes_kpacked(x, nd, transpose)
    dig = tu.to_signed_digits(x, nd)                         # [CH, *, *, nd]
    want = dig.permute(0, 3, 2, 1) if transpose else dig.permute(0, 3, 1, 2)
    assert got.shape == (16, nd, rows, k) and torch.equal(got, want)
    assert got.stride(-1) == 1 and got.stride(-2) % 16 == 0 and got.data_ptr() % 16 == 0
    store = torch.as_strided(got, (16, nd, rows, got.stride(-2)), got.stride())
    assert not store[..., k:].any()                          # the pads
    assert tmm.k_rows_ok(got)


@pytest.mark.parametrize("moduli,m,k,n", [(TOY, 16, 17, 8), (BIG, 24, 20, 12),
                                          (BIG, 8, 32, 5)])
def test_banded_plain_twin_equals_jax(moduli, m, k, n):
    """``banded_matmul_plain`` on the k-packed planes and tables against
    interpret-mode ``matmul_channels_pallas`` (several output tiles) and the
    XLA banded product ``matmul_channels_banded``: nd = 5 and 8, k off 16."""
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    L, nd = tr.num_limbs, tr.num_digits
    a = edge_residues(moduli, (8, m, k), 70 + m)
    b = edge_residues(moduli, (8, k, n), 80 + n)
    planes_a = tfm.digit_planes_kpacked(tu.u64_tensor(a).reshape(L * 8, m, k), nd)
    planes_b = tfm.digit_planes_kpacked(tu.u64_tensor(b).reshape(L * 8, k, n), nd,
                                        transpose=True)
    got = tu.u64_numpy(tfm.banded_matmul_plain(planes_a, planes_b,
                                               tfm._banded_tables(tr, 8, "cpu")))
    got = got.reshape(L, 8, m, n)
    jpair = lambda x: tuple(jnp.asarray(h) for h in ju.split_u64_np(x))
    joined = lambda p: ju.join_u64_np(np.asarray(p[0]), np.asarray(p[1]))
    np.testing.assert_array_equal(got, joined(jpm.matmul_channels_pallas(
        jpair(a), jpair(b), jr, tile_m=8, tile_n=4, interpret=True)))
    np.testing.assert_array_equal(got, joined(jmm.matmul_channels_banded(jpair(a), jpair(b),
                                                                         jr)))
    # the CPU launch wrapper takes the same twin
    np.testing.assert_array_equal(tu.u64_numpy(tfm.banded_matmul(
        planes_a, planes_b, tfm._banded_tables(tr, 8, "cpu"))).reshape(L, 8, m, n), got)


@pytest.mark.parametrize("moduli,S", [(TOY, 8), (BIG, 16)])
def test_banded_tables_cached(moduli, S):
    """Kernel 2's fold tables equal a fresh ``_pack_tables`` of 2nd - 1
    columns, each limb's row for its S channels, and are built once per
    ring, S and device."""
    ring = TRing(moduli, 8)
    before = tfm.table_builds
    t = tfm._banded_tables(ring, S, "cpu")
    fresh = tfm._pack_tables(ring, 2 * ring.num_digits - 1, tfm.BANDED_TABLE_WIDTH)
    np.testing.assert_array_equal(tu.u64_numpy(t), np.repeat(fresh, S, axis=0))
    assert tfm._banded_tables(ring, S, "cpu") is t
    assert tfm.table_builds == before + 1


@pytest.mark.parametrize("moduli,jr", [(TOY, 1), (TOY, 2), (BIG, 2)])
def test_prescale_tables_cached(moduli, jr):
    """Kernel 4's twiddle digits and per-limb constants equal fresh ones and
    are built once per ring, jr and device: a second r-stage uploads
    nothing."""
    ring = TRing(moduli, 8)
    before = tfm.table_builds
    ntab, tabs = tfm._prescale_tables(ring, jr, "cpu")
    assert torch.equal(ntab, tfm._prescale_ntab(ring, jr, "cpu"))
    np.testing.assert_array_equal(tu.u64_numpy(tabs),
                                  tfm._prescale_tabs(ring, ring.num_digits + jr - 1))
    again = tfm._prescale_tables(ring, jr, "cpu")
    assert again[0] is ntab and again[1] is tabs
    assert tfm.table_builds == before + 1
