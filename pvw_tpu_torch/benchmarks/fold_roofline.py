"""The int32 multiply-add peak of a card's CUDA cores.

The counterpart of ``vpu_peak_kernel`` in the JAX package's
``benchmarks/fold_roofline.py``: :func:`int32_peak` runs the TPU kernel's
function (``lanes`` independent int32 chains of multiply-adds over every
element of a tile, then their sum, wrapping) as ``csrc/int32_peak.cu``,
whose multiply-adds are each one IMAD; :func:`int32_peak_plain` is its
plain version. :func:`main` holds the kernel against it at the JAX
probe's shape, (512, 1024) with 512 multiply-adds an element, then times
it at the same tile with 65536 and twice that (the time must double: the
compiler folded nothing) and prints the measured rates: IMAD instructions
a second, and the JAX probe's count of 2 operations a multiply-add.

The rest of the JAX ``fold_roofline.main()`` (kernel 1 with and without
noise and encode, the int8 floor) is kernel 1's ablations, which
``chip_smoke.py`` measures.

Run it on a card: ``python3 -m pvw_tpu_torch.benchmarks.fold_roofline``.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..ops.u64 import M32
from ..ops._build import bind, check_args, launch, ptr
from . import INT32_OPS_PER_S, kernel_times, require_card

KERNEL = "int32_peak"
ENTRY = (KERNEL, "pvw_int32_peak",
         [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
#: The JAX probe's tile and its multiply-adds an element (fold_roofline.py:195-196)
TILE = (512, 1024)
CHECK_ITERS = 512
#: multiply-adds an element when timed: the tile's work at CHECK_ITERS is
#: ~16 us, below the launch noise
TIMED_ITERS = 65536
#: immediate multiply-adds a block of the kernel (csrc/int32_peak.cu's MADS);
#: every block adds one register multiply-add a chain
KERNEL_BLOCK = 256
LANES = (1, 2, 4, 8)


def int32_peak_plain(x, iters_inner: int, lanes: int = 8):
    """Plain PyTorch version of :func:`int32_peak`, in int64 arithmetic
    masked to 32 bits after every step (PyTorch does not promise a wrapping
    int32 multiply), the result read back as int32."""
    v = x.to(torch.int64)
    a = torch.arange(lanes, dtype=torch.int64, device=x.device).view(-1, *([1] * x.dim()))
    acc = (v + a) & M32
    for i in range(iters_inner // lanes):
        acc = (acc + v * (2 * (i * lanes + a) + 1)) & M32
    out = acc.sum(0) & M32
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def int32_peak(x, iters_inner: int, lanes: int = 8):
    """int32 x (any shape) -> int32 of its shape: for every element v,
    ``lanes`` chains acc_a = v + a, then iters_inner // lanes multiply-adds
    acc_a += v * (2 * (i * lanes + a) + 1), then the chains summed, all
    wrapping (the JAX probe's ``vpu_peak_kernel(iters_inner, lanes)``).

    CUDA tensors launch ``csrc/int32_peak.cu`` on the current stream
    (counted in ``int32_peak.launches``; lanes 1, 2, 4 or 8); CPU tensors
    take :func:`int32_peak_plain`; any other device raises."""
    dev = x.device
    if dev.type == "cpu":
        return int32_peak_plain(x, iters_inner, lanes)
    if dev.type != "cuda":
        raise ValueError(f"int32_peak: unsupported device {dev}")
    if lanes not in LANES or iters_inner < 0:
        raise ValueError(f"int32_peak: the kernel takes lanes in {LANES} and iters_inner "
                         f">= 0, got {lanes}, {iters_inner}")
    check_args(dev, {"x": (x, torch.int32, tuple(x.shape))})
    out = torch.empty_like(x)
    launch(KERNEL, bind(*ENTRY), dev, ptr(x), ptr(out), x.numel(), iters_inner, lanes)
    int32_peak.launches += 1
    return out


int32_peak.launches = 0


def imads(elements: int, iters_inner: int, lanes: int) -> int:
    """IMAD instructions the kernel issues: per element, each chain's
    multiply-adds plus one a chain for every whole block of KERNEL_BLOCK."""
    steps = iters_inner // lanes
    blocks = steps // (KERNEL_BLOCK // lanes)
    return elements * (steps * lanes + blocks * lanes)


def tile(device, seed: int = 0):
    """The JAX probe's input: int32 (512, 1024), values in [0, 100)."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 100, TILE).astype(np.int32)).to(device)


def measure(x, iters_inner: int = TIMED_ITERS, lanes: int = 8, reps: int = 5) -> dict:
    """The kernel timed at ``iters_inner`` and twice that (CUDA events,
    median of ``reps`` with the spread) -> the times, their ratio (the
    linearity: 2 when every multiply-add runs) and the rates: IMAD
    instructions, the function's multiply-adds (``madds``, counted) and the
    JAX probe's 2 operations a multiply-add, each a second at
    ``iters_inner``."""
    t1 = kernel_times(lambda: int32_peak(x, iters_inner, lanes), reps)
    t2 = kernel_times(lambda: int32_peak(x, 2 * iters_inner, lanes), reps)
    madds = x.numel() * (iters_inner // lanes) * lanes
    s = t1["ms"] / 1e3
    return {"iters_inner": iters_inner, "lanes": lanes, "elements": x.numel(),
            "ms": t1["ms"], "ms_spread": t1["ms_spread"], "ms_2x": t2["ms"],
            "ms_2x_spread": t2["ms_spread"], "linearity": t2["ms"] / t1["ms"],
            "madds": madds, "imad_per_s": imads(x.numel(), iters_inner, lanes) / s,
            "madd_per_s": madds / s, "jax_ops_per_s": 2 * madds / s}


def main(argv=None) -> int:
    dev = require_card()
    x = tile(dev)
    exact = torch.equal(int32_peak(x, CHECK_ITERS), int32_peak_plain(x, CHECK_ITERS))
    print(f"int32_peak {TILE} x {CHECK_ITERS} multiply-adds against its plain version: "
          f"bit-exact {exact}", flush=True)
    if not exact:
        raise RuntimeError("int32_peak differs from its plain version")
    r = measure(x)
    print(f"{r['iters_inner']} multiply-adds an element: {r['ms']:.3f} ms, twice as many "
          f"{r['ms_2x']:.3f} ms (x{r['linearity']:.3f})", flush=True)
    print(f"IMAD {r['imad_per_s']:.4e}/s; JAX count (2 ops a multiply-add) "
          f"{r['jax_ops_per_s']:.4e}/s; INT32_OPS_PER_S {INT32_OPS_PER_S:.4e}/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
