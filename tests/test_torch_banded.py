"""Kernel 2's entry points in the port against the JAX package, on the CPU.

``matmul_channels_fused`` and ``matmul_fold_auto`` (on the CPU the plain
twin ``modmat.matmul_channels``) are held against the Pallas kernel
``_fused_banded_matmul`` in interpret mode: through its own entry
``matmul_channels_pallas`` at nd = 5 and 8, and called on the band of
``_build_band_cmajor`` with C = 9 and 15 columns. Residues are canonical,
so the tolerance is 0: byte equality. The CUDA kernel is held against its
twin in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pvw_tpu.ops import pallas_modmat as jpm
from pvw_tpu.ops import modmat as jmm
from pvw_tpu.ops import u64 as ju
from pvw_tpu.params.ring import RingPlan as JRing
from pvw_tpu_torch.ops import fused_modmat as tfm
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params.ring import RingPlan as TRing

TOY = (0xFFFFC4001, 0x1FFFFE0001)                 # nd = 5: C = 9
BIG = (0x800000022A0001, 0x800000021A0001)        # nd = 8: C = 15


def residues(moduli, l, m, k, n, seed):
    """Random canonical residues lhs [L, l, m, k] and rhs [L, l, k, n], with
    0 and q - 1 among them."""
    rng = np.random.default_rng(seed)
    qs = np.array(moduli, np.uint64).reshape(-1, 1, 1, 1)
    a = rng.integers(0, 1 << 62, (len(moduli), l, m, k), dtype=np.uint64) % qs
    b = rng.integers(0, 1 << 62, (len(moduli), l, k, n), dtype=np.uint64) % qs
    a[:, :, 0, 0], b[:, :, 0, 0] = 0, qs[:, :, 0, 0] - 1
    a[:, :, -1, -1] = qs[:, :, 0, 0] - 1
    return a, b


def jpair(x):
    hi, lo = ju.split_u64_np(x)
    return jnp.asarray(hi), jnp.asarray(lo)


def joined(pair):
    return ju.join_u64_np(np.asarray(pair[0]), np.asarray(pair[1]))


@pytest.mark.parametrize("moduli,m,k,n,tiles", [
    (TOY, 16, 5, 8, (8, 4)), (BIG, 8, 7, 12, (8, 4))])
def test_matmul_channels_fused_equals_pallas_interpret(moduli, m, k, n, tiles):
    """Both entry points against ``matmul_channels_pallas`` in interpret
    mode (tiles of the output: several row and column tiles), nd = 5 and 8."""
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    a, b = residues(moduli, 8, m, k, n, 50 + k)
    want = joined(jpm.matmul_channels_pallas(jpair(a), jpair(b), jr, tile_m=tiles[0],
                                             tile_n=tiles[1], interpret=True))
    for entry in (tfm.matmul_channels_fused, tfm.matmul_fold_auto):
        got = entry(tu.u64_tensor(a), tu.u64_tensor(b), tr)
        np.testing.assert_array_equal(tu.u64_numpy(got), want)
    # the JAX package's XLA route (matmul_fold_auto off the TPU) agrees
    np.testing.assert_array_equal(joined(jpm.matmul_fold_auto(jpair(a), jpair(b), jr)), want)


@pytest.mark.parametrize("moduli,ncols", [(TOY, 9), (BIG, 15)])
def test_matmul_channels_fused_equals_fused_banded_matmul(moduli, ncols):
    """The twin against the Pallas kernel called on JAX's materialised band
    of ``ncols`` = 2nd - 1 columns, both of its folds (grouped, words)."""
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    assert jr.num_columns == ncols
    L, S, nd = jr.num_limbs, 8, jr.num_digits
    m, k, n = 8, 6, 8
    a, b = residues(moduli, S, m, k, n, ncols)
    ah, al = jpair(a)
    bh, bl = jpair(b)
    ld = jmm.digits(ah, al, nd).reshape(L * S, m, k * nd)
    band = jpm._build_band_cmajor(jmm.digits(bh, bl, nd).reshape(L * S, k, n, nd))
    assert band.shape == (L * S, ncols, k * nd, n)
    tables = jnp.repeat(jnp.asarray(jpm._pack_tables(jr)), S, axis=0)
    got = tu.u64_numpy(tfm.matmul_channels_fused(tu.u64_tensor(a), tu.u64_tensor(b), tr))
    for use_words in sorted({False, jr.fold_words_ok}):
        oh, ol = jpm._fused_banded_matmul(ld, band, tables, 8, 4, True, use_words)
        np.testing.assert_array_equal(got, joined((oh, ol)).reshape(L, S, m, n))


@pytest.mark.parametrize("moduli", [TOY, BIG])
def test_banded_tables_equal_jax(moduli):
    """Kernel 2's fold table (q, the bias of 2nd - 1 columns, four groups of
    2^(32g) mod q and its Shoup companion) holds the JAX package's values."""
    tr, jr = TRing(moduli, 8), JRing(moduli, 8)
    t = tfm.pack_tables(tr, tr.num_columns, tfm.BANDED_TABLE_WIDTH)
    jt = jpm._pack_tables(jr).astype(np.uint64)
    pair = lambda hi, lo: (jt[:, hi] << np.uint64(32)) | jt[:, lo]
    np.testing.assert_array_equal(t[:, 0], pair(18, 19))
    np.testing.assert_array_equal(t[:, 1], pair(16, 17))
    for g in range(4):
        np.testing.assert_array_equal(t[:, 2 + 2 * g], pair(g, 4 + g))
        np.testing.assert_array_equal(t[:, 3 + 2 * g], pair(8 + g, 12 + g))


def test_matmul_channels_fused_refuses():
    """Mismatched shapes, a contraction past the int32 headroom and a device
    that is neither the CPU nor a card raise."""
    tr = TRing(TOY, 8)
    a = torch.zeros((2, 8, 4, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="does not match"):
        tfm.matmul_channels_fused(a, torch.zeros((2, 8, 4, 5), dtype=torch.int64), tr)
    with pytest.raises(ValueError, match="headroom"):
        tfm.matmul_channels_fused(torch.zeros((2, 8, 1, 9000), dtype=torch.int64),
                                  torch.zeros((2, 8, 9000, 1), dtype=torch.int64), tr)
    with pytest.raises(ValueError, match="unsupported device"):
        tfm.matmul_channels_fused(a.to("meta"), torch.zeros((2, 8, 3, 5), dtype=torch.int64,
                                                           device="meta"), tr)
