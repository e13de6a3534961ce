"""The measurement probes of the JAX package's ``benchmarks/``, on a card.

Each module is named after its JAX counterpart and holds the counterparts
of that probe's TPU kernels (hand-written CUDA, with plain PyTorch
versions that CPU tensors take) and of its ``main()``:

- :mod:`.probe_twopass`: the two-pass product, ``torch._int_mm`` into int32
  digit columns then the fold kernel ``fold_only``, against kernel 1;
- :mod:`.fold_roofline`: the int32 multiply-add peak (``int32_peak``);
- :mod:`.probe_dot_structure`: kernel 1's contraction with a trivial
  epilogue in three band layouts (``dot_structure``).

Their paths run at the full width of the dealer path's c2 product, the two
shapes of :data:`C2_SHAPES`. Run one on a card with
``python3 -m pvw_tpu_torch.benchmarks.probe_twopass`` (and the other two).
"""

from __future__ import annotations

import statistics
from typing import NamedTuple

from ..params.ring import get_ring
from ..utils.intmath import generate_ntt_primes


class NttPrimes(NamedTuple):
    """A chain named by its primes: the first ``count`` NTT primes of
    ``bits`` bits for the ring degree (``generate_ntt_primes``)."""

    bits: int
    count: int


#: The c2 product of the two dealer paths, which chip_smoke.py's toy and
#: config-4 constants are read from: label -> (moduli or their NttPrimes,
#: ring degree, m receivers, k, n dealers); the toy chain,
#: ``presets.vector_k256(4096)`` (CH = 16, kd = 1280, nd = 5), and BASELINE
#: config 4,
#: ``presets.threshold_256bit(1024)`` (CH = 272, kd = 4096, nd = 8), whose
#: primes are found at first use (it takes seconds).
C2_SHAPES = {
    "toy": ((0xFFFFC4001, 0x1FFFFE0001), 8, 4096, 256, 4096),
    "config-4": (NttPrimes(61, 17), 16, 1024, 512, 1024),
}

# H100 SXM peaks (NVIDIA data sheet), the bounds of the probes and of
# chip_smoke.py: HBM bandwidth and the dense int8 tensor-core rate. 32-bit
# integer instructions (add, logic, shift, multiply-add: one each) on the
# CUDA cores: at most one warp instruction a clock from each of an SM's four
# schedulers, 132 SMs x 128 lanes x the 1.98 GHz boost clock. Not the IMAD
# rate alone: fold_roofline measures 1.6e13 multiply-adds a second, 64 a
# clock an SM, but the compiler also issues integer adds on the INT32 pipe
# beside them, and the v3k generator measured 2.69e13 instructions a second
# (PERF.md). Not the 67e12 float32 rate, which counts an FMA twice.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
INT32_OPS_PER_S = 132 * 128 * 1.98e9


def c2_shape(label: str):
    """(ring, m, k, n) of the c2 product ``label`` of :data:`C2_SHAPES`."""
    moduli, l, m, k, n = C2_SHAPES[label]
    if isinstance(moduli, NttPrimes):
        moduli = generate_ntt_primes(moduli.bits, moduli.count, l)
    return get_ring(tuple(moduli), l), m, k, n


def cuda_times(fn, reps: int, warmup: int = 1) -> list:
    """Milliseconds of ``fn`` in each of ``reps`` runs (CUDA events around
    each, after ``warmup`` runs)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (:func:`cuda_times`)."""
    return statistics.median(cuda_times(fn, reps, warmup))


def kernel_times(fn, reps: int = 5, warmup: int = 1) -> dict:
    """The median milliseconds of ``fn`` over ``reps`` runs
    (:func:`cuda_times`) and their spread [min, max]."""
    times = cuda_times(fn, reps, warmup)
    return {"ms": statistics.median(times), "ms_spread": [min(times), max(times)]}


def require_card():
    """The CUDA device the probes measure on; raises without one (a probe
    never falls back to the CPU)."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the probes measure a CUDA card: torch.cuda.is_available() is "
                           "False")
    return torch.device("cuda")
