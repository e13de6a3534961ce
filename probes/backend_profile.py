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
counted once), the idle share 1 - device / wall, and the ten entries with
the most device time. When the profiler records no device time the line
says so (``device_ms`` null).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def profiled(fn, activities) -> dict:
    """``fn()`` once under the profiler: wall ms, device ms, idle share and
    the ten entries with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the card's own events (kernels, copies, fills); the CPU ops that
    # launched them report the same time again, and the profiler's buffer
    # request is not the program's work
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
    device = sum(e.self_device_time_total for e in on_device) / 1e3
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall, "device_ms": device or None,
            "idle_share": 1 - device / wall if device else None,
            "top": [{"name": e.key[:90], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in top]}


def run(dev, activities, card: str, n: int) -> None:
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
                out = profiled(lambda: encrypt(R.key(2)), activities)
            finally:
                del settings.noise_stream
            cs.emit({"probe": "backend_profile", "case": name, "stream": stream,
                     "config": "BASELINE config 4", "dealers": n, "card": card, **out})


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity

    if not torch.cuda.is_available():
        print("backend_profile: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    run(torch.device("cuda"), [ProfilerActivity.CPU, ProfilerActivity.CUDA], cs.card_line(),
        cs.DEEP_N)
    return 0


if __name__ == "__main__":
    sys.exit(main())
