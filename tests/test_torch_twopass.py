"""The two-pass probe of the port against the JAX package's, on the CPU.

``pvw_tpu_torch.benchmarks.probe_twopass`` is held against
``benchmarks/probe_twopass.py``: its fold ``fold_only`` (on the CPU the
plain version, the grouped fold of ``modmat._fold_leading``) against the
JAX TPU kernel ``fold_only`` run in interpret mode, over int32 columns
drawn from the whole int32 range, with the JAX fold word-regrouped and
not; ``pass1_dot`` against the JAX ``pass1_dot`` on the same residues; and
the probe's own check, the two passes equal to kernel 1 bare. Residues are
canonical, so the tolerance is 0. The CUDA kernel is held against its
plain version in ``tests/test_torch_cuda.py``.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pvw_tpu.ops import modmat as jmm
from pvw_tpu.ops import u64 as ju
from pvw_tpu.ops.pallas_modmat import _pack_tables as jax_pack_tables
from pvw_tpu.params.ring import get_ring as jax_ring
from pvw_tpu_torch.benchmarks import c2_shape
from pvw_tpu_torch.benchmarks import probe_twopass as tp
from pvw_tpu_torch.ops import fused_modmat as fm
from pvw_tpu_torch.ops import modmat as tmm
from pvw_tpu_torch.ops import u64 as tu
from pvw_tpu_torch.params import presets
from pvw_tpu_torch.params.ring import get_ring as torch_ring

ROOT = Path(__file__).resolve().parents[1]
TOY = (0xFFFFC4001, 0x1FFFFE0001)                   # nd = 5
DEEP = (0x1FFFFFFFFFFFFFE1, 0x1FFFFFFFFFFFFCE1)     # 61-bit NTT primes (l = 8), nd = 8


def load_probe(name: str):
    """``benchmarks/<name>.py`` as a module: it reads ``sys.argv`` when it
    is imported, so ``sys.argv`` is ``[name]`` meanwhile."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    argv = sys.argv
    sys.argv = [name]
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.argv = argv
    return mod


@pytest.fixture(scope="module")
def jax_probe():
    return load_probe("probe_twopass")


def int32_columns(shape, seed):
    """int32 columns over the whole int32 range, both ends among them."""
    cols = np.random.default_rng(seed).integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
    cols[..., 0, :, 0] = -(1 << 31)
    cols[..., 1, :, 1] = (1 << 31) - 1
    return cols.astype(np.int32)


@pytest.mark.parametrize("moduli,use_words", [(TOY, False), (TOY, True), (DEEP, False),
                                              (DEEP, True)])
def test_fold_only_equals_pallas_interpret(jax_probe, moduli, use_words):
    """The port's ``fold_only`` against the JAX TPU kernel ``fold_only`` in
    interpret mode (CH = 16, m = 16, n = 128, tiles 8 x 128), its tables
    ``_pack_tables(ring, nd)`` repeated per slot: (hi, lo) joined as
    hi * 2^32 + lo, equal to every residue."""
    jring, tring = jax_ring(moduli, 8), torch_ring(moduli, 8)
    L, S, nd = jring.num_limbs, jring.degree, jring.num_digits
    cols = int32_columns((L * S, 16, nd, 128), 7 + nd)
    tables = jnp.repeat(jnp.asarray(jax_pack_tables(jring, nd)), S, axis=0)
    with pltpu.force_tpu_interpret_mode():
        hi, lo = jax_probe.fold_only(jnp.asarray(cols), tables, 8, 128, use_words)
    want = ju.join_u64_np(np.asarray(hi), np.asarray(lo))
    got = tp.fold_only(torch.from_numpy(cols), tring)
    assert got.dtype == torch.int64 and tuple(got.shape) == (L * S, 16, 128)
    np.testing.assert_array_equal(tu.u64_numpy(got), want)


@pytest.mark.parametrize("moduli,m,k,n", [(TOY, 8, 5, 12), (DEEP, 17, 3, 8)])
def test_pass1_dot_equals_jax(jax_probe, moduli, m, k, n):
    """The port's ``pass1_dot`` (on the CPU the exact float64 product) on
    the band of ``prescale_digits_band`` against the JAX ``pass1_dot`` on
    the 6-D ``prescale_digits`` of the same residues: every int32 column."""
    jring, tring = jax_ring(moduli, 8), torch_ring(moduli, 8)
    L, S = jring.num_limbs, jring.degree
    rng = np.random.default_rng(m + k)
    qs = np.array(moduli, np.uint64)
    lhs = rng.integers(0, 1 << 62, (m, k, L, S), dtype=np.uint64) % qs[:, None]
    rhs = rng.integers(0, 1 << 62, (L, S, k, n), dtype=np.uint64) % qs[:, None, None, None]
    lh, ll = map(jnp.asarray, ju.split_u64_np(lhs))
    rh, rl = map(jnp.asarray, ju.split_u64_np(rhs))
    want = np.asarray(jax_probe.pass1_dot(jmm.lhs_digit_planes(lh, ll, jring),
                                          jmm.prescale_digits((rh, rl), jring), jring))
    lhs_dig = tmm.lhs_digit_planes(tu.u64_tensor(lhs), tring)
    band = tmm.prescale_digits_band(tu.u64_tensor(rhs), tring)
    got = tp.pass1_dot(lhs_dig, band)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("moduli,m,k,n", [(TOY, 16, 7, 24), (DEEP, 9, 4, 10)])
def test_two_pass_equals_kernel1_bare(moduli, m, k, n):
    """The probe's own check on the CPU: the two passes give kernel 1's
    bare product (its plain twin ``matmul_fold_scaled_plain``), every
    residue, and so does ``fold_only_plain`` of the same columns."""
    ring = torch_ring(moduli, 8)
    lhs_dig, band = tp.operands(ring, m, k, n, 3, torch.device("cpu"))
    res = tp.run(lhs_dig, band, ring)
    assert res["equal"]
    L, S = ring.num_limbs, ring.degree
    bare = fm.matmul_fold_scaled_plain(None, band, ring, lhs_dig=lhs_dig)
    assert torch.equal(res["A"], bare.reshape(L * S, m, n))
    assert torch.equal(res["C"], tp.fold_only_plain(res["cols"], ring))


def test_two_pass_refuses_what_it_cannot_fold():
    """Columns that do not match the ring, and devices other than the CPU
    and CUDA, raise."""
    ring = torch_ring(TOY, 8)
    with pytest.raises(ValueError, match="do not match the ring"):
        tp.fold_only(torch.zeros((16, 2, 4, 3), dtype=torch.int32), ring)
    with pytest.raises(ValueError, match="unsupported device"):
        tp.fold_only(torch.zeros((16, 2, 5, 3), dtype=torch.int32, device="meta"), ring)
    lhs_dig, band = tp.operands(ring, 4, 3, 5, 1, torch.device("cpu"))
    with pytest.raises(ValueError, match="does not match the band"):
        tp.pass1_dot(lhs_dig[..., :-1], band)


@pytest.mark.parametrize("label,preset,dealers,ch,nd", [
    ("toy", presets.vector_k256, 4096, 16, 5),
    ("config-4", presets.threshold_256bit, 1024, 272, 8)])
def test_c2_shapes_are_the_dealer_paths(label, preset, dealers, ch, nd):
    """The probes' c2 shapes are the dealer paths' presets: the same chain,
    ring degree, receivers and k (config 4's chain named by its primes)."""
    ring, m, k, n = c2_shape(label)
    params = preset(dealers)
    assert tuple(ring.moduli) == tuple(params.moduli()) and ring.degree == params.l
    assert (m, k, n) == (params.n, params.k, dealers)
    assert (ring.num_limbs * ring.degree, ring.num_digits) == (ch, nd)
