"""Threshold decryption over a validated subset of dealer ciphertexts, the
counterpart of ``examples/pvw_valid_dec.py`` (the reference's
``examples/pvw_valid_dec.rs``): the 128-bit parameter set (four 55-bit
primes, k = 1024, variance 10, explicit bounds), external validation marks
a random subset of dealers valid, the protocol aborts below threshold, and
parties decrypt only the valid ciphertexts, dealer indices preserved.

Run: ``python -m pvw_tpu_torch.examples.pvw_valid_dec [--device cpu|cuda]
[--dimension 1024]``
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dimension", type=int, default=1024)
    args = ap.parse_args(argv)

    from pvw_tpu_torch import (GlobalPublicKey, Party, PvwCrs, PvwParametersBuilder,
                               decrypt_valid_shares, encrypt_all_party_shares_batched)
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.errors import InsufficientValidCiphertexts

    dev = args.device
    # 128-bit security parameters (examples/pvw_valid_dec.rs:40-52)
    moduli = (0x800000022A0001, 0x800000021A0001, 0x80000002120001, 0x80000001F60001)
    num_parties = 5
    threshold = 2
    ring_degree = 8
    secret_variance = 10.0
    bound1, bound2 = 1, 1172385

    params = (PvwParametersBuilder().set_parties(num_parties).set_dimension(args.dimension)
              .set_l(ring_degree).set_moduli(moduli).set_secret_variance(secret_variance)
              .set_error_bounds_u32(bound1, bound2).build())
    print("PVW Parameters:")
    print(f"  Parties: {params.n}, Threshold: {threshold}, Dimension: {params.k}, "
          f"Ring degree: {params.l}")
    print(f"  Delta: {params.delta()}, Modulus bits: {params.q_total().bit_length()}")
    print(f"  Correctness condition: "
          f"{'OK' if params.verify_correctness_condition() else 'NOT satisfied'}")

    key = R.key(1)
    t0 = time.time()
    crs = PvwCrs.new(params, R.fold_in(key, 0), device=dev)
    gpk = GlobalPublicKey(crs)
    parties = [Party.new(i, params, R.fold_in(key, 100 + i), device=dev)
               for i in range(num_parties)]
    gpk.generate_all_party_keys(parties, R.fold_in(key, 1))
    print(f"Setup: {time.time() - t0:.3f}s")

    vectors = [[d * 1000 + j + 1 for j in range(num_parties)] for d in range(num_parties)]

    # one batched encryption for all dealers; decrypt_valid_shares takes
    # the batched ciphertext directly
    t0 = time.time()
    cts = encrypt_all_party_shares_batched(vectors, gpk, R.fold_in(key, 2))
    print(f"Encryption ({num_parties} dealers): {time.time() - t0:.3f}s")

    # Simulated external validation (pvw_valid_dec.rs:160-178)
    rng = np.random.default_rng(7)
    order = rng.permutation(num_parties)
    num_valid = threshold + int(rng.integers(0, num_parties - threshold + 1))
    valid = [int(i) for i in order[:num_valid]]
    print(f"\nValidation: {num_valid}/{num_parties} dealer ciphertexts valid "
          f"-> {sorted(valid)}")

    # Abort path: fewer than threshold
    try:
        decrypt_valid_shares(cts, valid[:threshold - 1], threshold, parties[0].secret_key, 0)
        raise SystemExit("abort path failed to trigger")
    except InsufficientValidCiphertexts as e:
        print(f"Below-threshold abort works: {e}")

    # Every party decrypts the valid subset (dealer indices preserved)
    t0 = time.time()
    all_ok = True
    for pi, party in enumerate(parties):
        for dealer_idx, share in decrypt_valid_shares(cts, valid, threshold,
                                                      party.secret_key, pi):
            expect = vectors[dealer_idx][pi]
            if share != expect:
                all_ok = False
                print(f"  MISMATCH party {pi} dealer {dealer_idx}: {share} != {expect}")
    print(f"Threshold decryption ({num_parties} parties x {num_valid} valid "
          f"ciphertexts): {time.time() - t0:.3f}s")
    print("All valid shares recovered correctly." if all_ok else "FAILURES detected")
    if not all_ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
