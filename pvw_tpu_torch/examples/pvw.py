"""Multi-party PVW vector encryption demo, the counterpart of
``examples/pvw.py`` (the reference's ``examples/pvw.rs``): n parties each
encrypt a vector of values (dealer rows), every party decrypts exactly its
own column, and the full n x n share matrix is verified, with timings.

Run: ``python -m pvw_tpu_torch.examples.pvw [--device cpu|cuda]``
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--parties", type=int, default=7)
    ap.add_argument("--dimension", type=int, default=32)
    args = ap.parse_args(argv)

    from pvw_tpu_torch import (GlobalPublicKey, Party, PvwCrs, PvwParameters,
                               PvwParametersBuilder, decrypt_party_shares,
                               encrypt_all_party_shares_batched)
    from pvw_tpu_torch import random as R

    dev = args.device
    print("=== Multi-Party Vector Encryption Demo ===\n")

    # Configuration (examples/pvw.rs:28-34)
    num_parties = args.parties
    ring_degree = 8
    dimension = args.dimension
    secret_variance = 0.5
    moduli = (0xFFFFC4001, 0x1FFFFE0001)

    b1, b2 = PvwParameters.suggest_error_bounds(num_parties, dimension, ring_degree, moduli,
                                                secret_variance)
    print(f"Suggested bound1: {b1}, Suggested bound2: {b2}, "
          f"Secret variance: {secret_variance}")
    params = (PvwParametersBuilder().set_parties(num_parties).set_dimension(dimension)
              .set_l(ring_degree).set_moduli(moduli).set_secret_variance(secret_variance)
              .set_error_bounds_u32(b1, b2).build())
    print("PVW Parameters:")
    print(f"  Parties: {params.n}, Dimension: {params.k}, Ring degree: {params.l}")
    print(f"  Delta: {params.delta()}, Modulus bits: {params.q_total().bit_length()}")
    print(f"  Correctness condition: "
          f"{'OK' if params.verify_correctness_condition() else 'NOT satisfied'}\n")

    key = R.key(0)

    # Setup: CRS + all party keys (examples/pvw.rs:84-92)
    t0 = time.time()
    crs = PvwCrs.new(params, R.fold_in(key, 0), device=dev)
    gpk = GlobalPublicKey(crs)
    parties = [Party.new(i, params, R.fold_in(key, 100 + i), device=dev)
               for i in range(num_parties)]
    gpk.generate_all_party_keys(parties, R.fold_in(key, 1))
    _sync(dev)
    print(f"Setup (CRS + {num_parties} keys): {time.time() - t0:.3f}s")

    # Share matrix: dealer d encrypts value d*1000 + j for recipient j
    vectors = np.array([[d * 1000 + j + 1 for j in range(num_parties)]
                        for d in range(num_parties)], np.uint64)
    print("\nShare Distribution Matrix (rows = dealers):")
    for d in range(num_parties):
        print("  " + " ".join(f"{int(v):6d}" for v in vectors[d]))

    # Encrypt all dealers at once (one batched encryption)
    t0 = time.time()
    ct = encrypt_all_party_shares_batched(vectors, gpk, R.fold_in(key, 2))
    _sync(dev)
    print(f"\nEncryption ({num_parties} dealers x {num_parties} receivers): "
          f"{time.time() - t0:.3f}s")

    # Each party decrypts its column from every dealer
    t0 = time.time()
    ok = total = 0
    for pi, party in enumerate(parties):
        shares = decrypt_party_shares(ct, party.secret_key, pi)
        for d in range(num_parties):
            total += 1
            ok += shares[d] == int(vectors[d][pi])
    print(f"Decryption ({total} values): {time.time() - t0:.3f}s")
    print(f"\nVerification: {ok}/{total} correct ({100.0 * ok / total:.1f}%)")
    if ok != total:
        sys.exit(1)
    print("All shares recovered correctly.")


if __name__ == "__main__":
    main()
