"""pvw_tpu_torch: the PVW multi-receiver LWE scheme in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper.

The PyTorch port of ``pvw_tpu`` (JAX/Pallas). Module paths and public names
mirror it: ``params`` (PvwParameters(Builder), PvwCrs, RingPlan), ``keys``
(SecretKey, Party, PublicKey, GlobalPublicKey), ``crypto`` (encrypt*,
decrypt*, threshold decryption, PvwCiphertext), ``sampling``, ``errors``,
``traits``, ``interop`` (the ``pvw-vectors-v1`` exchange),
``utils.serialization`` (the PVWT bytes) and ``ops`` (the digit matmuls, the
NTT, the fused kernels). Residues are canonical int64 tensors; every
entry point takes ``device=`` (default ``"cuda"``, which raises without a
card) and threefry keys from :mod:`pvw_tpu_torch.random`.
"""

from . import config, errors, random, traits  # noqa: F401
from .params import PvwCrs, PvwParameters, PvwParametersBuilder, RingPlan
from .poly import Poly, Representation
from .keys import GlobalPublicKey, Party, PublicKey, SecretKey
from .crypto import (
    PvwCiphertext,
    decode_scalar_pvw_rns,
    decrypt_party_shares,
    decrypt_party_value,
    decrypt_valid_shares,
    encrypt,
    encrypt_all_party_shares,
    encrypt_all_party_shares_batched,
    encrypt_batch,
    encrypt_broadcast,
    encrypt_party_shares,
    select_valid_ciphertexts,
)
from .errors import PvwError, PvwResult
from .sampling import sample_vec_cbd
from .traits import Encode, Serialize, Validate

__version__ = "0.1.0"

__all__ = [
    "Encode", "GlobalPublicKey", "Party", "Poly", "PublicKey", "PvwCiphertext", "PvwCrs",
    "PvwError", "PvwParameters", "PvwParametersBuilder", "PvwResult", "Representation",
    "RingPlan", "SecretKey", "Serialize", "Validate", "decode_scalar_pvw_rns", "decrypt_party_shares",
    "decrypt_party_value", "decrypt_valid_shares", "demo_roundtrip", "encrypt",
    "encrypt_all_party_shares", "encrypt_all_party_shares_batched", "encrypt_batch",
    "encrypt_broadcast", "encrypt_party_shares", "sample_vec_cbd",
    "select_valid_ciphertexts",
]


def demo_roundtrip(verbose: bool = True, device="cuda") -> bool:
    """Toy params -> CRS -> keygen -> encrypt -> per-party decrypt ->
    verify, on ``device`` (the twin of ``pvw_tpu.demo_roundtrip``).
    Returns True on success."""
    import numpy as np

    moduli = (0xFFFFC4001, 0x1FFFFE0001)
    n, k, l = 3, 8, 8
    b1, b2 = PvwParameters.suggest_error_bounds(n, k, l, moduli, 0.5)
    p = (PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
         .set_moduli(moduli).set_secret_variance(0.5)
         .set_error_bounds_u32(b1, b2).build())
    key = random.key(0)
    crs = PvwCrs.new(p, random.fold_in(key, 1), device=device)
    gpk = GlobalPublicKey(crs)
    parties = [Party.new(i, p, random.fold_in(key, 100 + i), device=device)
               for i in range(n)]
    gpk.generate_all_party_keys(parties, random.fold_in(key, 2))
    scalars = np.array([11, 22, 33], np.uint64)
    ct = encrypt(scalars, gpk, random.fold_in(key, 3))
    ok = True
    for i, party in enumerate(parties):
        got = decrypt_party_value(ct, party.secret_key, i)
        if verbose:
            print(f"party {i}: decrypted {got}, expected {int(scalars[i])}")
        ok &= got == int(scalars[i])
    if verbose:
        print("round-trip", "OK" if ok else "FAILED")
    return ok
