"""PVW encryption: vector, share-distribution and broadcast modes.

The counterpart of ``pvw_tpu.crypto.encryption`` (the reference's
``encryption.rs``): c1 = A·r + e1, c2 = B·r + e2 + encode(m), batched over
d independent encryptions so both products are one fused scaled-digit
matmul each (:func:`~pvw_tpu_torch.ops.fused_modmat.matmul_fold_scaled`),
with the noise NTT and the gadget encode inside the kernel. On deep chains
the r-stage (signed NTT + scaled-digit band) is one kernel too
(:func:`~pvw_tpu_torch.ops.fused_modmat.ntt_prescale_band`).

Randomness is counter-based: the same key gives the same ciphertexts as
the JAX package on the CPU. Stream routing follows the JAX package off the
TPU: ``"kernel"``/``"v4"`` and ``"v3"`` draw v3 noise planes, ``"v3k"``
draws v3k planes and the cbd-k r stream.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..errors import InvalidParameters
from ..keys.public_key import GlobalPublicKey
from ..ops import modmat, ntt as ntt_ops, u64 as u64op
from ..ops.fused_modmat import (encode_tab, matmul_fold_scaled, ntt_prescale_available,
                                ntt_prescale_band)
from ..params.parameters import PvwParameters
from ..poly import Poly, Representation
from ..random import split
from ..sampling.cbd import cbd_bound, sample_vec_cbd_rows


class PvwCiphertext:
    """c1 in R_q^k, c2 in R_q^n (``encryption.rs:15-24``); batch shapes
    (k,)/(n,), or (k, d)/(n, d) for d batched encryptions."""

    def __init__(self, c1: Poly, c2: Poly, params: PvwParameters) -> None:
        self.c1 = c1
        self.c2 = c2
        self.params = params

    def __len__(self) -> int:
        """Number of encrypted values == n (``encryption.rs:27-30``)."""
        return self.c2.batch_shape[0]

    def validate(self) -> None:
        """``encryption.rs:41-76``."""
        if self.c1.batch_shape[0] != self.params.k:
            raise InvalidParameters(
                f"c1 has {self.c1.batch_shape[0]} components but should have "
                f"k={self.params.k}"
            )
        if self.c2.batch_shape[0] != self.params.n:
            raise InvalidParameters(
                f"c2 has {self.c2.batch_shape[0]} components but should have "
                f"n={self.params.n}"
            )
        if self.c1.ring != self.params.ring or self.c2.ring != self.params.ring:
            raise InvalidParameters("ciphertext context mismatch")

    def get_party_ciphertext(self, party_index: int) -> Optional[Poly]:
        """``encryption.rs:82-84``."""
        if 0 <= party_index < self.c2.batch_shape[0]:
            return self.c2[party_index]
        return None

    def __repr__(self) -> str:
        return f"PvwCiphertext(k={self.c1.batch_shape}, n={self.c2.batch_shape})"


def _check_bounds(params: PvwParameters) -> None:
    """The port draws noise as signed digit planes only."""
    for name, b in (("error_bound_1", params.error_bound_1),
                    ("error_bound_2", params.error_bound_2)):
        if b >= min(params.ring.moduli):
            raise NotImplementedError(
                f"{name} {b} >= smallest modulus needs the exact host noise "
                "path, which is not ported to pvw_tpu_torch yet")
        if not ntt_ops.signed_digit_count(b):
            raise NotImplementedError(
                f"{name} {b} > 32639 needs the residue-noise path, which is "
                "not ported to pvw_tpu_torch yet")


def _encrypt_kernel(params: PvwParameters, a_dig, b_dig, sc, key,
                    encode32: bool = False, stream: str | None = None,
                    col_off: int = 0):
    """d-batched PVW encryption. a_dig int8 [L, l, k, k*nd] and b_dig int8
    [L, l, n, k*nd] are the cached lhs planes; sc int64 [d, n] are the u64
    scalars (bit patterns); ``encode32``: all scalars < 2^32; ``stream``:
    None (v3 planes) or "v3k". The r-stage takes the fused NTT + prescale
    kernel where ``settings.use_fused_prescale`` and
    :func:`ntt_prescale_available` allow. Returns channel-major c1
    [L, l, k, d] and c2 [L, l, n, d]."""
    from ..config import settings

    ring = params.ring
    k, n, l = params.k, params.n, params.l
    d = sc.shape[0]
    dev = sc.device
    k_r, k_e1, k_e2 = split(key, 3)

    # r: CBD coefficients [k, d, l] -> signed NTT -> scaled digit band
    if stream == "v3k":
        from ..ops import tfry

        rk0, rk1 = tfry.key_words(k_r)
        r_coeffs = tfry.v3k_cbd_values(rk0, rk1, 0, k, d, l,
                                       params.secret_variance, col_off, dev)
    else:
        r_coeffs = sample_vec_cbd_rows(k_r, 0, k, (d, l),
                                       params.secret_variance, dev)
    r_bound = cbd_bound(params.secret_variance)
    if (settings.use_fused_prescale(ring.num_digits)
            and ntt_prescale_available(ring, k, d, r_bound, dev)):
        # deep chains (nd >= 8): NTT + prescale in one kernel
        r_op = ntt_prescale_band(r_coeffs, ring, r_bound)
    else:
        r_ch = ntt_ops.ntt_forward_signed_ch(r_coeffs, ring, r_bound)
        r_op = modmat.prescale_digits_band(r_ch, ring)       # [L, l, nd, k*nd, d]

    def noise_planes(kk, rows, bound):
        if stream == "v3k":
            from ..ops import tfry

            k0, k1 = tfry.key_words(kk)
            return tfry.v3k_noise_digit_planes(k0, k1, 0, rows, d, l, bound,
                                               col_off, dev)
        return ntt_ops.noise_digit_planes(kk, 0, rows, d, l, bound, dev)

    b1, b2 = params.error_bound_1, params.error_bound_2
    c1 = matmul_fold_scaled(None, r_op, ring, noise=noise_planes(k_e1, k, b1),
                            lhs_dig=a_dig, noise_bound=b1)
    etab = u64op.u64_tensor(encode_tab(params.gadget_ntt, params.gadget_ntt_shoup,
                                       params.gadget_wrap), dev)
    c2 = matmul_fold_scaled(None, r_op, ring, noise=noise_planes(k_e2, n, b2),
                            encode=(sc.t().contiguous(), etab), lhs_dig=b_dig,
                            encode32=encode32, noise_bound=b2)
    return c1, c2


def encrypt_batch(all_scalars, global_pk: GlobalPublicKey, key) -> PvwCiphertext:
    """Encrypt d scalar vectors ([d, n] u64) in one call: c1 [k, d],
    c2 [n, d], on the key matrix's device."""
    from ..config import settings

    params = global_pk.params
    arr = np.asarray(all_scalars, np.uint64)
    if arr.ndim != 2 or arr.shape[1] != params.n:
        raise InvalidParameters(
            f"Must provide exactly n={params.n} scalars, got "
            f"{arr.shape[-1] if arr.ndim else 0}"
        )
    if not global_pk.is_full():
        raise InvalidParameters(
            "Global public key is not complete (missing party keys)"
        )
    if not params.verify_correctness_condition():
        raise InvalidParameters(
            "Parameters do not satisfy correctness condition - decryption "
            "may fail"
        )
    _check_bounds(params)
    encode32 = not bool(np.any(arr >> np.uint64(32)))
    sc = u64op.u64_tensor(arr, global_pk.device)
    a_dig, b_dig = global_pk.encrypt_operands()
    c1, c2 = _encrypt_kernel(params, a_dig, b_dig, sc, key, encode32,
                             settings.kernel_noise_stream())
    return PvwCiphertext(Poly.from_channel_major(c1, Representation.Ntt, params.ring),
                         Poly.from_channel_major(c2, Representation.Ntt, params.ring),
                         params)


def _squeeze_batch(ct: PvwCiphertext) -> PvwCiphertext:
    def squeeze(p: Poly) -> Poly:
        return Poly.from_channel_major(p.channel()[..., 0], p.rep, p.ring)

    return PvwCiphertext(squeeze(ct.c1), squeeze(ct.c2), ct.params)


def encrypt(scalars, global_pk: GlobalPublicKey, key) -> PvwCiphertext:
    """Encrypt one length-n vector: party i can decrypt scalars[i]
    (``encryption.rs:105-214``)."""
    arr = np.asarray(scalars, np.uint64)
    if arr.ndim != 1:
        raise InvalidParameters("scalars must be a 1-D vector")
    ct = _squeeze_batch(encrypt_batch(arr[None, :], global_pk, key))
    ct.validate()
    return ct


def encrypt_party_shares(party_shares, party_index: int,
                         global_pk: GlobalPublicKey, key) -> PvwCiphertext:
    """PVSS dealer mode (``encryption.rs:221-245``)."""
    params = global_pk.params
    if party_index >= params.n:
        raise InvalidParameters(
            f"Party index {party_index} exceeds maximum {params.n - 1}"
        )
    shares = np.asarray(party_shares, np.uint64)
    if shares.shape != (params.n,):
        raise InvalidParameters(
            f"Party must provide {params.n} shares, got "
            f"{shares.shape[0] if shares.ndim else 0}"
        )
    return encrypt(shares, global_pk, key)


def encrypt_all_party_shares_batched(all_shares, global_pk: GlobalPublicKey,
                                     key) -> PvwCiphertext:
    """All n dealers in one call: ONE PvwCiphertext with c1 [k, n_dealers],
    c2 [n, n_dealers] (``encryption.rs:253-286``)."""
    params = global_pk.params
    shares = np.asarray(all_shares, np.uint64)
    if shares.ndim != 2 or shares.shape[0] != params.n:
        raise InvalidParameters(f"Must provide shares for all {params.n} parties")
    if shares.shape[1] != params.n:
        raise InvalidParameters(
            f"Dealer 0 provided {shares.shape[1]} shares but needs {params.n}"
        )
    return encrypt_batch(shares, global_pk, key)


def encrypt_all_party_shares(all_shares, global_pk: GlobalPublicKey,
                             key) -> list[PvwCiphertext]:
    """:func:`encrypt_all_party_shares_batched` split into one ciphertext
    per dealer, for API parity."""
    ct = encrypt_all_party_shares_batched(all_shares, global_pk, key)
    c1, c2 = ct.c1.channel(), ct.c2.channel()
    return [PvwCiphertext(
        Poly.from_channel_major(c1[..., d], Representation.Ntt, ct.params.ring),
        Poly.from_channel_major(c2[..., d], Representation.Ntt, ct.params.ring),
        ct.params) for d in range(c1.shape[-1])]


def encrypt_broadcast(scalar: int, global_pk: GlobalPublicKey, key) -> PvwCiphertext:
    """Same value for every party (``encryption.rs:292-296``)."""
    return encrypt(np.full((global_pk.params.n,), np.uint64(scalar), np.uint64),
                   global_pk, key)
