#!/usr/bin/env python3
"""The multi-device backends at config 4 with each shard on its own card.

Run from the root of the repository on a machine with four NVIDIA H100s:

    python3 probes/multicard_backends.py [--one-card] [--runs R] [--multiprocess]

Builds the kernels, makes BASELINE config 4 (``presets.threshold_256bit(1024)``)
with random keys from a seed on cuda:0, then runs ``chip_smoke.phase_backends``
under v3k and the default stream with the shard devices cuda:0-3: the (2, 2)
mesh, the forced-masked (1, 1) mesh on cuda:0, four dealer shards, four limb
groups and two limb groups x a (1, 2) mesh. Each backend's ciphertext is held
``torch.equal`` to the single-device one on cuda:0, sampled shares exact, its
launches gated as in ``chip_smoke.py``; one JSON line each with host-clocked
encryption and decryption times (every card synchronized). The shards run in
turn from one process: this is the port's serial shard loop across cards,
not concurrent scaling. Exits non-zero on a failed gate or with fewer than
four cards. ``--one-card`` puts every shard on cuda:0, as ``chip_smoke.py``
does, and ``--runs R`` repeats the backends R times on the same keys: the
spread of their host-clocked times between runs of one call.

``--multiprocess`` runs the multi-process leg alone
(``chip_smoke.phase_multiprocess``): the reference's 128-bit preset
(``secure_128_reference(1024)``, 1024 dealers, v3k) on the (2, 2) mesh
across four processes, rank r on cuda:r over NCCL (one rank a card), beside
the same system's in-process (2, 2) mesh over cuda:0-3 and its
single-device encryption; with ``--one-card`` the four ranks share cuda:0
over gloo and the in-process mesh repeats cuda:0.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv) -> int:
    import torch

    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.ops import _build, fused_modmat as fm
    from pvw_tpu_torch.params import presets

    ap = argparse.ArgumentParser()
    ap.add_argument("--one-card", action="store_true")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--multiprocess", action="store_true")
    args = ap.parse_args(argv)
    cards = 1 if args.one_card else 4
    if not torch.cuda.is_available() or torch.cuda.device_count() < cards:
        print(f"multicard_backends: needs {cards} CUDA card(s)", file=sys.stderr)
        return 2
    _build.build_all([fm.KERNEL, fm.PRESCALE_KERNEL, fm.NOISE_KERNEL, fm.RESIDUE_NOISE_KERNEL,
                      cs.DECODE_KERNEL, fm.CONTRACTION_KERNEL])
    card = cs.card_line()
    print(card, flush=True)
    devices = [torch.device("cuda", 0 if args.one_card else i) for i in range(4)]
    if args.multiprocess:
        for _ in range(args.runs):
            cs.phase_multiprocess(card, devices)
        cs.emit({"probe": "multicard_backends", "leg": "multiprocess", "ok": True,
                 "cards": torch.cuda.device_count()})
        return 0
    dev = torch.device("cuda", 0)
    n = cs.DEEP_N
    params = presets.threshold_256bit(n)
    key = R.key(4)
    crs = P.PvwCrs.new(params, R.fold_in(key, 0), device=dev)
    coeffs = P.sample_vec_cbd(R.fold_in(key, 10_000), (n, params.k, params.l),
                              params.secret_variance, device=dev)
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_keys_device(coeffs, R.fold_in(key, 1))
    keys = (gpk, coeffs.cpu().numpy())
    del coeffs
    for _ in range(args.runs):
        for stream, seed in (("v3k", 10), ("kernel", 11)):
            cs.phase_backends(dev, card, params, keys, stream, seed, devices=devices)
    cs.emit({"probe": "multicard_backends", "ok": True, "cards": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
