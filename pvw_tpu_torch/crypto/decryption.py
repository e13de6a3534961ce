"""PVW decryption: the inner product and the exact decode.

The counterpart of ``pvw_tpu.crypto.decryption`` (the reference's
``decryption.rs``):

1. z = <s, c1> - c2[i] as a channel-major digit contraction over k, then
   one inverse NTT, batched over dealers, on the ciphertexts' device;
2. the exact sequential-rounding decode with the reference's conventions
   (centering only above q//2, sign-split rounding division, Rust's
   truncated %, the final clamp of small negatives to 0), routed by
   :func:`_decode_mode` (``PVW_TPU_DECODE``): on the residues' device
   (:mod:`.device_decode`; the only host fetch is 8 bytes a message), or
   :func:`decode_scalar_pvw_rns` on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import DecodingError, InvalidParameters
from ..keys.secret_key import SecretKey
from ..ops import modmat, ntt as ntt_ops, u64 as u64op
from ..params.parameters import PvwParameters
from ..utils.intmath import center_mod, rust_div, rust_rem
from . import device_decode
from .encryption import PvwCiphertext


def _noisy_messages(params: PvwParameters, sk_ntt, c1_ch, c2_ch) -> torch.Tensor:
    """sk_ntt [k, L, l]; c1_ch [L, l, k, d]; c2_ch [L, l, d] (NTT) ->
    PowerBasis residues of <s, c1> - c2, int64 [d, L, l] on c1's device."""
    ring = params.ring
    skc = sk_ntt.permute(1, 2, 0)[:, :, None, :]                  # [L, l, 1, k]
    prod = modmat.matmul_channels(skc, c1_ch, ring)[:, :, 0]       # [L, l, d]
    q = ring.table("q", prod.device)[:, None, None]
    z = u64op.submod(prod, c2_ch, q).permute(2, 0, 1)              # [d, L, l]
    return ntt_ops.ntt_inverse(z, ring)


def decode_scalar_pvw_rns(coeff_residues: np.ndarray, params: PvwParameters) -> int:
    """Decode one noisy gadget-encoded message from its PowerBasis residues
    (uint64 [L, l]): the exact transcription of ``decryption.rs:10-58``."""
    ring = params.ring
    q = params.q_total()
    delta = params.delta()
    ell = params.l
    if tuple(coeff_residues.shape) != (ring.num_limbs, ell):
        raise DecodingError(
            f"residue block shape {tuple(coeff_residues.shape)} does not "
            f"match the parameter set's [L={ring.num_limbs}, l={ell}]"
        )
    zc = [center_mod(v, q) for v in ring.lift_to_ints(coeff_residues)]
    tmp = [(zc[i] * delta - zc[i + 1]) % q for i in range(ell - 1)]
    last = tmp[0]
    for i in range(1, ell - 1):
        last = (last * delta + tmp[i]) % q
    a = center_mod(last, q)
    m = center_mod(params.delta_power_l_minus_1() % q, q)
    reduced = rust_rem(a, m)
    half_mod = rust_div(m, 2)
    if reduced > half_mod:
        reduced -= m
    elif reduced < -half_mod:
        reduced += m
    tmp.append(reduced % q)
    noise = [0] * ell
    noise[ell - 1] = tmp[ell - 1]
    d_const = center_mod(delta % q, q)
    for i in range(ell - 2, -1, -1):
        a = center_mod((noise[i + 1] - tmp[i]) % q, q)
        if d_const == 0:
            quot = 0
        elif a < 0:
            quot = rust_div(a * 2 - d_const, d_const * 2)
        else:
            quot = rust_div(a * 2 + d_const, d_const * 2)
        noise[i] = quot % q
    mf = center_mod((-zc[0] - noise[0]) % q, q)
    # extract_constant_term_as_u64 (decryption.rs:226-247)
    if mf < 0:
        if -mf <= 1000:
            return 0
        pos = (mf + q) % q
        return pos if pos < 1 << 64 else 0
    return mf if mf < 1 << 64 else 0


def _decode_mode(params: PvwParameters) -> str:
    """The decode engine for ``params`` under ``PVW_TPU_DECODE``, the
    counterpart of the JAX package's router for the engines the port has:
    ``"device"`` for ``auto`` and ``device`` where
    :func:`~.device_decode.decode_supported` holds, else ``"python"``.
    ``auto`` sends every batch size to the device (the JAX package sends
    batches below its crossover to a host engine the port lacks); where the
    device decode does not cover the parameters, ``auto`` takes the Python
    decode, counted in ``_decode_mode.python_fallbacks``, and ``device``
    raises. ``host`` and ``native`` raise (not ported)."""
    from ..config import settings

    mode = settings.resolved_decode_mode()
    if mode == "python":
        return mode
    if device_decode.decode_supported(params):
        return "device"
    if mode == "device":
        raise InvalidParameters(
            "PVW_TPU_DECODE='device': the device decode does not cover this "
            f"parameter set (delta = {params.delta()}, l = {params.l})")
    _decode_mode.python_fallbacks += 1
    return "python"


_decode_mode.python_fallbacks = 0


def _decode_batch(residues: torch.Tensor, params: PvwParameters) -> list[int]:
    """Decode the messages of PowerBasis residues int64 [d, L, l] on any
    device, by :func:`_decode_mode`: on the residues' device, fetching the
    d messages alone (8 bytes each), or by the Python decode on the host."""
    if _decode_mode(params) == "device":
        out = device_decode.decode_residues(device_decode.get_plan(params), residues)
        return [int(v) for v in u64op.u64_numpy(out)]
    res = u64op.u64_numpy(residues)
    return [decode_scalar_pvw_rns(res[i], params) for i in range(res.shape[0])]


def decrypt_party_value(ciphertext: PvwCiphertext, secret_key: SecretKey,
                        party_index: int) -> int:
    """Decrypt component ``party_index`` (``decryption.rs:249-278``)."""
    params = ciphertext.params
    if not (0 <= party_index < params.n):
        raise InvalidParameters(
            f"Party index {party_index} exceeds maximum {params.n - 1}"
        )
    c1 = ciphertext.c1.channel()[..., None]                      # [L, l, k, 1]
    c2 = ciphertext.c2.channel()[:, :, party_index][..., None]   # [L, l, 1]
    sk = secret_key.to_polynomials(c1.device).res
    return _decode_batch(_noisy_messages(params, sk, c1, c2), params)[0]


def decrypt_party_shares(all_ciphertexts, secret_key: SecretKey,
                         party_index: int) -> list[int]:
    """This party's share from every dealer ciphertext
    (``decryption.rs:281-325``): a list of n PvwCiphertexts, or one batched
    PvwCiphertext (c1 [k, d], c2 [n, d] with d = n)."""
    if isinstance(all_ciphertexts, PvwCiphertext):
        ct = all_ciphertexts
        params = ct.params
        if len(ct.c1.batch_shape) != 2:
            raise InvalidParameters("expected a batched ciphertext")
        d = ct.c1.batch_shape[1]
        if d != params.n:
            raise InvalidParameters(f"Expected {params.n} ciphertexts, got {d}")
        if not (0 <= party_index < params.n):
            raise InvalidParameters(
                f"Party index {party_index} exceeds maximum {params.n - 1}"
            )
        c1 = ct.c1.channel()                                     # [L, l, k, d]
        c2 = ct.c2.channel()[:, :, party_index]                  # [L, l, d]
    else:
        if len(all_ciphertexts) == 0:
            raise InvalidParameters("No ciphertexts provided")
        params = all_ciphertexts[0].params
        if len(all_ciphertexts) != params.n:
            raise InvalidParameters(
                f"Expected {params.n} ciphertexts, got {len(all_ciphertexts)}"
            )
        if not (0 <= party_index < params.n):
            raise InvalidParameters(
                f"Party index {party_index} exceeds maximum {params.n - 1}"
            )
        for i, ct in enumerate(all_ciphertexts):
            try:
                ct.validate()
            except InvalidParameters as e:
                raise InvalidParameters(f"Ciphertext {i} invalid: {e}") from e
        c1 = torch.stack([ct.c1.channel() for ct in all_ciphertexts], dim=-1)
        c2 = torch.stack([ct.c2.channel()[:, :, party_index]
                          for ct in all_ciphertexts], dim=-1)
    sk = secret_key.to_polynomials(c1.device).res
    return _decode_batch(_noisy_messages(params, sk, c1, c2), params)
