"""Threshold / validated-subset decryption.

The counterpart of ``pvw_tpu.crypto.threshold`` (the reference's flow in
``examples/pvw_valid_dec.rs:160-209``): external validation marks a subset
of dealer ciphertexts as valid; the protocol aborts if fewer than
``threshold`` are valid; every party decrypts only the valid subset, and
the dealer indices are kept for reconstruction. The valid dealer columns
are gathered into one [k, s] block, the inner products run as one
contraction on the ciphertexts' device, and the exact decode runs once over
the whole subset, routed as in :mod:`.decryption` for the subset's size: a
subset below the crossover decrypts wholly on the host, a larger one
decodes on that device by default (fetching 8 bytes a share).
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from ..errors import InsufficientValidCiphertexts, InvalidParameters
from ..keys.secret_key import SecretKey
from ..utils.profiling import span
from .decryption import _decrypt
from .encryption import PvwCiphertext


def _validate_indices(n: int, valid_dealer_indices: Sequence[int],
                      threshold: int) -> None:
    seen = set()
    for i in valid_dealer_indices:
        if not (0 <= i < n):
            raise InvalidParameters(f"dealer index {i} out of range 0..{n - 1}")
        if i in seen:
            raise InvalidParameters(f"duplicate dealer index {i}")
        seen.add(i)
    if len(valid_dealer_indices) < threshold:
        raise InsufficientValidCiphertexts(len(valid_dealer_indices), threshold)


def select_valid_ciphertexts(
    all_ciphertexts: Sequence[PvwCiphertext],
    valid_dealer_indices: Sequence[int],
    threshold: int,
) -> list[tuple[int, PvwCiphertext]]:
    """Filter to the externally validated subset, aborting below threshold
    (``pvw_valid_dec.rs:160-195``). Returns (dealer_index, ciphertext)
    pairs so share reconstruction can track provenance."""
    _validate_indices(len(all_ciphertexts), valid_dealer_indices, threshold)
    return [(i, all_ciphertexts[i]) for i in valid_dealer_indices]


def _check_party(params, party_index: int) -> None:
    if not (0 <= party_index < params.n):
        raise InvalidParameters(
            f"Party index {party_index} exceeds maximum {params.n - 1}"
        )


def _valid_columns(all_ciphertexts, idx_list: list, threshold: int, party_index: int):
    """(params, c1 [L, l, k, s], c2 [L, l, s]): the valid dealers' columns,
    channel-major, after the checks."""
    if isinstance(all_ciphertexts, PvwCiphertext):
        ct = all_ciphertexts
        params = ct.params
        if len(ct.c1.batch_shape) != 2:
            raise InvalidParameters("expected a batched ciphertext")
        d = ct.c1.batch_shape[1]
        if d != params.n:
            raise InvalidParameters(f"Expected {params.n} ciphertexts, got {d}")
        _check_party(params, party_index)
        _validate_indices(d, idx_list, threshold)
        c1 = ct.c1.channel()                                     # [L, l, k, d]
        sel = torch.as_tensor(idx_list, dtype=torch.long, device=c1.device)
        c1 = c1.index_select(3, sel)
        c2 = ct.c2.channel()[:, :, party_index].index_select(2, sel)   # [L, l, s]
        return params, c1, c2
    selected = select_valid_ciphertexts(all_ciphertexts, idx_list, threshold)
    params = selected[0][1].params
    _check_party(params, party_index)
    c1 = torch.stack([c.c1.channel() for _, c in selected], dim=-1)
    c2 = torch.stack([c.c2.channel()[:, :, party_index] for _, c in selected], dim=-1)
    return params, c1, c2


def decrypt_valid_shares(
    all_ciphertexts: Union[PvwCiphertext, Sequence[PvwCiphertext]],
    valid_dealer_indices: Sequence[int],
    threshold: int,
    secret_key: SecretKey,
    party_index: int,
) -> list[tuple[int, int]]:
    """Decrypt this party's share from each VALID dealer ciphertext
    (``pvw_valid_dec.rs:192-209``). Returns (dealer_index, share) pairs in
    the order given; raises :class:`InsufficientValidCiphertexts` below
    threshold.

    Accepts a list of n PvwCiphertexts or one batched PvwCiphertext from
    ``encrypt_all_party_shares_batched``; either way the subset decrypts
    as one contraction. The call is the span ``pvw.decrypt``; the checks
    and the gather ``pvw.decrypt.select``, then :func:`.decryption._decrypt`'s.
    """
    idx_list = list(valid_dealer_indices)
    with span("pvw.decrypt", valid=len(idx_list)):
        with span("pvw.decrypt.select"):
            params, c1, c2 = _valid_columns(all_ciphertexts, idx_list, threshold,
                                            party_index)
        return list(zip(idx_list, _decrypt(params, secret_key, c1, c2)))
