#!/usr/bin/env python3
"""Where the time of one config-4 encryption goes on one card, single-device
and through the (2, 2) mesh: device time by kernel and the device's idle
share, from ``torch.profiler``.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 probes/backend_profile.py

Builds BASELINE config 4 (``presets.threshold_256bit(1024)``) with random
keys from a seed, then for four cases, the single-device encryption and the
(2, 2) mesh over cuda:0 repeated four times, each under v3k (the mesh: the
masked form) and the default stream (the mesh: the bake route), runs one
encryption of 1024 dealers to warm up and one under ``torch.profiler``
(CPU and CUDA activities). Per case one JSON line: the host wall time of
the profiled call (the profiler's own overhead included), the summed device
time of everything the card ran (its kernels, copies and fills, each
counted once) and their count, the idle share 1 - device / wall, and the
ten entries with the most device time (``chip_smoke.profiled``). When the profiler records no device time the line
says so (``device_ms`` null).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def run(dev, card: str, n: int) -> None:
    import pvw_tpu_torch as P
    import pvw_tpu_torch.parallel as TP
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.params import presets

    params = presets.threshold_256bit(n)
    key = R.key(4)
    crs = P.PvwCrs.new(params, R.fold_in(key, 0), device=dev)
    coeffs = P.sample_vec_cbd(R.fold_in(key, 10_000), (n, params.k, params.l),
                              params.secret_variance, device=dev)
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_keys_device(coeffs, R.fold_in(key, 1))
    shares = np.random.default_rng(4).integers(0, 1 << 32, size=(n, n), dtype=np.uint64)
    mesh = TP.make_mesh([dev] * 4)
    cases = (("single device", lambda k: P.encrypt_batch(shares, gpk, k)),
             ("(2, 2) mesh", lambda k: TP.encrypt_batch_sharded(shares, gpk, k, mesh)))
    for stream in ("v3k", "kernel"):
        for name, encrypt in cases:
            settings.noise_stream = stream
            try:
                encrypt(R.key(1))
                out = cs.profiled(lambda: encrypt(R.key(2)))
            finally:
                del settings.noise_stream
            cs.emit({"probe": "backend_profile", "case": name, "stream": stream,
                     "config": "BASELINE config 4", "dealers": n, "card": card, **out})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("backend_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    run(torch.device("cuda"), cs.card_line(), cs.DEEP_N)
    return 0


if __name__ == "__main__":
    sys.exit(main())
