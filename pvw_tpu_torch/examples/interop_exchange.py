"""Exchange PVW material by value through ``pvw_tpu_torch.interop``
(``pvw-vectors-v1``), the counterpart of ``examples/interop_exchange.py``:
parameters, CRS, secret keys and a ciphertext dumped to the documented
JSON schema, reloaded and decrypted, NTT slot order bridged through the
monomial probe.

Run: ``python -m pvw_tpu_torch.examples.interop_exchange [--device cpu|cuda]``
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from pvw_tpu_torch import (GlobalPublicKey, Party, PvwCrs, PvwParameters,
                               PvwParametersBuilder, decrypt_party_value, encrypt, interop)
    from pvw_tpu_torch import random as R

    dev = args.device
    moduli = (0xFFFFC4001, 0x1FFFFE0001)
    n, k, l = 5, 32, 8
    b1, b2 = PvwParameters.suggest_error_bounds(n, k, l, moduli, 0.5)
    params = (PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
              .set_moduli(moduli).set_secret_variance(0.5).set_error_bounds_u32(b1, b2)
              .build())
    key = R.key(0)
    crs = PvwCrs.new(params, R.fold_in(key, 0), device=dev)
    gpk = GlobalPublicKey(crs)
    parties = [Party.new(i, params, R.fold_in(key, 10 + i), device=dev) for i in range(n)]
    gpk.generate_all_party_keys(parties, R.fold_in(key, 1))

    scalars = np.array([101, 202, 303, 404, 505], np.uint64)
    ct = encrypt(scalars, gpk, R.fold_in(key, 2))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "exchange.json")
        interop.dump_case(params, crs=crs, secret_keys=[p.secret_key for p in parties],
                          ciphertext=ct, scalars=scalars.tolist(),
                          plaintexts=scalars.tolist(), path=path)
        print(f"dumped pvw-vectors-v1 case ({os.path.getsize(path) / 1024:.0f} KiB)")

        loaded = interop.load_case(path, device=dev)
        if loaded.params != params:
            raise SystemExit("params did not round-trip")
        print("params round-tripped; NTT bridge:",
              "identity" if loaded.bridge.perms[0] == list(range(params.l)) else "permuted")
        for i, sk in enumerate(loaded.secret_keys):
            got = decrypt_party_value(loaded.ciphertext, sk, i)
            print(f"  party {i}: decrypted {got}, expected {int(scalars[i])}")
            if got != int(scalars[i]):
                raise SystemExit(f"party {i} decrypted {got}")
    print("interop exchange OK")


if __name__ == "__main__":
    main()
