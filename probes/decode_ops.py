#!/usr/bin/env python3
"""How many torch ops one device decode issues, and where its time goes.

Run from the root of the repository, on a machine with an NVIDIA H100 or,
with ``--device cpu``, anywhere:

    python3 probes/decode_ops.py [--device cpu]

For the toy chain (``presets.pvss_8192(4096)``, 4096 messages), BASELINE
config 4 (``presets.threshold_256bit(1024)``) and the reference's 128-bit
parameters (``presets.secure_128_reference(1024)``), both at 1024 messages,
decodes a batch of uniform residues from a seed with
``crypto/device_decode.decode_residues`` and prints one JSON line each: the
aten ops one decode dispatches (views and bare allocations left out: on a
card, about its kernel launches; ``chip_smoke.op_count``), the most
frequent of them, and the host-clocked ms of one decode (the median of 3,
after a first call that uploads the plan's tables). On a card it also gives
one decode under ``torch.profiler`` (``chip_smoke.profiled``): the card's
busy ms, its event count and idle share.
"""

from __future__ import annotations

import argparse
import collections
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from pvw_tpu_torch.crypto import device_decode
    from pvw_tpu_torch.ops import u64
    from pvw_tpu_torch.params import presets

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args(argv).device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("decode_ops: torch.cuda.is_available() is False (try --device cpu)",
              file=sys.stderr)
        return 2
    card = cs.card_line() if dev.type == "cuda" else "cpu"
    for label, params, d in (("toy chain", presets.pvss_8192(cs.N_RECEIVERS), cs.N_RECEIVERS),
                             ("config 4", presets.threshold_256bit(cs.DEEP_N), cs.DEEP_N),
                             ("reference", presets.secure_128_reference(cs.REF_N), cs.REF_N)):
        rng = np.random.default_rng(0)
        res = np.stack([rng.integers(0, m, size=(d, params.l), dtype=np.uint64)
                        for m in params.ring.moduli], 1)
        z = u64.u64_tensor(res, dev)
        plan = device_decode.get_plan(params)

        def decode():
            return u64.u64_numpy(device_decode.decode_residues(plan, z))

        decode()
        kinds = collections.Counter()

        class Kinds(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kinds[func.__name__.split(".")[0]] += 1
                return func(*args, **(kwargs or {}))

        with Kinds():
            decode()
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            decode()
            times.append((time.perf_counter() - t0) * 1e3)
        rec = {"probe": "decode_ops", "config": label, "device": str(dev), "card": card,
               "messages": d, "limbs": params.ring.num_limbs, "l": params.l,
               "words": plan.W, "ops": cs.op_count(decode),
               "most_frequent": dict(kinds.most_common(10)),
               "ms": statistics.median(times), "ms_runs": times}
        rec["ms_per_message"] = rec["ms"] / d
        if dev.type == "cuda":
            rec["profile"] = cs.profiled(decode)
        cs.emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
