"""Sharded PVW deployment demo, the counterpart of
``examples/pvw_sharded.py``: the PVSS flow of ``pvw.py`` over several
devices, through every multi-device backend:

1. the (recv, kdim) mesh: B and c2 row-sharded over receivers, the k
   contraction split over kdim, gathered and added mod q
   (``encrypt_batch_sharded``);
2. RNS limb-parallel: limb-restricted shards, no collectives
   (``encrypt_batch_limb_parallel``); 2b. the dealer split under v3k
   (``encrypt_batch_data_parallel``);
3. the grid of limb groups x the (recv, kdim) mesh (``encrypt_batch_grid``).

Each backend's ciphertext is checked byte for byte against the
single-device encryption under the same key (counter-based randomness),
then decrypted with the decode in its shards.

Run: ``python -m pvw_tpu_torch.examples.pvw_sharded [--device cpu|cuda]
[--devices 8]``. The mesh takes ``--devices`` devices: the visible cards in
turn, a card repeated when there are fewer (one card gives a mesh of
``cuda:0`` repeated), or the CPU repeated.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def mesh_devices(device: str, count: int) -> list:
    """``count`` devices of ``device``'s type: the visible cards in turn
    (repeated when there are fewer), or the CPU repeated."""
    import torch

    from pvw_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * count
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(count)]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--parties", type=int, default=64)
    ap.add_argument("--dimension", type=int, default=64)
    ap.add_argument("--dealers", type=int, default=16)
    args = ap.parse_args(argv)

    from pvw_tpu_torch import (GlobalPublicKey, Party, PvwCrs, PvwParameters,
                               PvwParametersBuilder, encrypt_batch)
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.parallel import (decrypt_party_shares_grid,
                                        decrypt_party_shares_limb_parallel,
                                        decrypt_party_shares_sharded, encrypt_batch_data_parallel,
                                        encrypt_batch_grid, encrypt_batch_limb_parallel,
                                        encrypt_batch_sharded, make_mesh)

    devices = mesh_devices(args.device, args.devices)
    print(f"devices: {len(devices)} x {devices[0].type} "
          f"({len(set(devices))} distinct: {sorted({str(d) for d in devices})})")

    # the 4 x 55-bit chain of the JAX example
    moduli = (0x80000000080001, 0x80000000130001, 0x80000000190001, 0x800000001D0001)
    n, k, d = args.parties, args.dimension, args.dealers
    b1, b2 = PvwParameters.suggest_error_bounds(n, k, 8, moduli, 0.5)
    params = (PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(8)
              .set_moduli(moduli).set_secret_variance(0.5).set_error_bounds_u32(b1, b2)
              .build())
    key = R.key(0)
    crs = PvwCrs.new(params, R.fold_in(key, 0), device=devices[0])
    parties = [Party.new(i, params, R.fold_in(key, 100 + i), device=devices[0])
               for i in range(n)]
    gpk = GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, R.fold_in(key, 1))

    vectors = np.array([[dd * 10 + r + 1 for r in range(n)] for dd in range(d)], np.uint64)
    enc_key = R.fold_in(key, 5)
    ct_ref = encrypt_batch(vectors, gpk, enc_key)          # single-device reference

    def check(tag, ct_like, ref, decrypt_fn, party):
        same = (np.array_equal(ct_like.c1.residues_np(), ref.c1.residues_np())
                and np.array_equal(ct_like.c2.residues_np(), ref.c2.residues_np()))
        ok = decrypt_fn(party) == [int(vectors[dd][party]) for dd in range(d)]
        print(f"  {tag}: bit-identical={same}, decrypt ok={ok}")
        if not (same and ok):
            raise SystemExit(f"{tag} failed")

    # 1. (recv, kdim) mesh
    mesh = make_mesh(devices)
    t0 = time.time()
    ct = encrypt_batch_sharded(vectors, gpk, enc_key, mesh)
    print(f"(recv={mesh.shape['recv']}, kdim={mesh.shape['kdim']}) mesh encrypt in "
          f"{time.time() - t0:.2f}s")
    check("mesh", ct, ct_ref,
          lambda p: decrypt_party_shares_sharded(ct, parties[p].secret_key, p, mesh), 1)

    # 2. limb-parallel (one RNS limb group per device, no collectives)
    lp_devs = devices[:min(len(devices), params.ring.num_limbs)]
    t0 = time.time()
    ct_lp = encrypt_batch_limb_parallel(vectors, gpk, enc_key, lp_devs)
    print(f"limb-parallel over {len(lp_devs)} devices encrypt in {time.time() - t0:.2f}s")
    check("limb-parallel", ct_lp.gather(), ct_ref,
          lambda p: decrypt_party_shares_limb_parallel(ct_lp, parties[p].secret_key, p), 2)

    # 2b. the dealer split (no collectives; bit-identical to the
    # single-device batch under the v3k stream)
    settings.noise_stream = "v3k"
    try:
        ct_ref_v3k = encrypt_batch(vectors, gpk, enc_key)
        t0 = time.time()
        ct_dp = encrypt_batch_data_parallel(vectors, gpk, enc_key, devices[:4]).gather()
        print(f"data-parallel over {len(devices[:4])} devices encrypt in "
              f"{time.time() - t0:.2f}s")
        check("data-parallel", ct_dp, ct_ref_v3k,
              lambda p: decrypt_party_shares_sharded(ct_dp, parties[p].secret_key, p,
                                                     make_mesh(devices[:1], kdim=1)), 4)
    finally:
        del settings.noise_stream

    # 3. the grid: limb groups x (recv, kdim)
    if len(devices) >= 4:
        t0 = time.time()
        ct_g = encrypt_batch_grid(vectors, gpk, enc_key, devices, limb_groups=2,
                                  kdim=2 if len(devices) >= 8 else 1)
        print(f"3-axis GRID over {len(devices)} devices encrypt in {time.time() - t0:.2f}s")
        check("grid", ct_g.gather(), ct_ref,
              lambda p: decrypt_party_shares_grid(ct_g, parties[p].secret_key, p), 3)

    print("sharded deployment demo OK")


if __name__ == "__main__":
    main()
