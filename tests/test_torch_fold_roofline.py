"""The port's int32 peak probe against the JAX package's, on the CPU.

``pvw_tpu_torch.benchmarks.fold_roofline.int32_peak`` (on the CPU its
plain version, int64 arithmetic masked to int32 wrap) is held against the
JAX TPU kernel ``vpu_peak_kernel`` of ``benchmarks/fold_roofline.py`` in
interpret mode, on inputs whose multiply-adds overflow int32: exact
equality. The CUDA kernel is held against its plain version, and its time
against twice the work, in ``tests/test_torch_cuda.py``.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pvw_tpu_torch.benchmarks import fold_roofline as fr

ROOT = Path(__file__).resolve().parents[1]


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
    return load_probe("fold_roofline")


def overflowing(shape, seed):
    """int32 values across the whole range (the products wrap), both ends
    and 0 among them."""
    x = np.random.default_rng(seed).integers(-(1 << 31), 1 << 31, shape, dtype=np.int64)
    x.flat[:3] = [-(1 << 31), (1 << 31) - 1, 0]
    return x.astype(np.int32)


@pytest.mark.parametrize("shape", [(8, 128), (16, 256)])
@pytest.mark.parametrize("iters", [16, 64])
@pytest.mark.parametrize("lanes", [8, 1])
def test_int32_peak_equals_pallas_interpret(jax_probe, shape, iters, lanes):
    x = overflowing(shape, iters + lanes)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_probe.vpu_peak_kernel(iters, lanes)(jnp.asarray(x)))
    got = fr.int32_peak(torch.from_numpy(x), iters, lanes)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("iters,lanes", [(20, 8), (7, 2), (0, 4)])
def test_int32_peak_partial_steps_equal_pallas_interpret(jax_probe, iters, lanes):
    """iters_inner not a multiple of lanes runs iters_inner // lanes steps,
    as the TPU kernel's loop does; 0 sums the chains' starting values."""
    x = overflowing((8, 128), 5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_probe.vpu_peak_kernel(iters, lanes)(jnp.asarray(x)))
    np.testing.assert_array_equal(fr.int32_peak(torch.from_numpy(x), iters, lanes).numpy(),
                                  want)


def test_imad_count_follows_the_kernel_blocks():
    """The IMADs the rates count: each chain's multiply-adds plus one a chain
    for every whole block of 256 (csrc/int32_peak.cu's register term)."""
    assert fr.imads(1, 512, 8) == 512 + 2 * 8
    assert fr.imads(10, 65536, 8) == 10 * (65536 + 256 * 8)
    assert fr.imads(3, 20, 8) == 3 * 16
    assert fr.imads(1, 300, 1) == 300 + 1
