"""PVW decryption: the inner product and the exact decode.

The counterpart of ``pvw_tpu.crypto.decryption`` (the reference's
``decryption.rs``):

1. z = <s, c1> - c2[i] as a channel-major digit contraction over k, then
   one inverse NTT, batched over dealers, on the ciphertexts' device;
2. the exact sequential-rounding decode with the reference's conventions
   (centering only above q//2, sign-split rounding division, Rust's
   truncated %, the final clamp of small negatives to 0).

:func:`_decode_mode` (``PVW_TPU_DECODE``) routes as the JAX package does:
batches below ``settings.decode_crossover`` decrypt wholly on the host in
the C++ engine (``host``: :func:`_host_decrypt`), the rest decode on the
residues' device (``device``: :mod:`.device_decode`; the only host fetch
is 8 bytes a message), in the C++ engine (``native``) or by
:func:`decode_scalar_pvw_rns` (``python``). :data:`engine_calls` counts
the decoded batches of each engine.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..errors import DecodingError, InvalidParameters
from ..keys.secret_key import SecretKey
from ..ops import modmat, ntt as ntt_ops, u64 as u64op
from ..params.parameters import PvwParameters
from ..utils import native_decode
from ..utils.intmath import center_mod, rust_div, rust_rem
from ..utils.profiling import span
from . import device_decode
from .encryption import PvwCiphertext

#: Batches decoded by each engine: ``host`` (the whole decryption in the
#: C++ engine), ``native`` (the C++ decode of device residues), ``device``
#: and ``python``.
engine_calls = SimpleNamespace(host=0, native=0, device=0, python=0)


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


def _decode_mode(params: PvwParameters, d: int | None = None) -> str:
    """The decode engine for a batch of ``d`` messages of ``params`` under
    ``PVW_TPU_DECODE``, as the JAX package routes it: ``auto`` takes
    ``host`` below the crossover where the host engine covers the
    parameters, else ``device``; ``host`` where the engine does not cover
    them (or ``no_native``) becomes ``device``; ``device`` where the device
    decode does not cover them becomes ``native``. The backends pass no d."""
    from ..config import settings

    mode = settings.resolved_decode_mode()
    if mode == "auto":
        if (d is not None and d < settings.decode_crossover
                and native_decode.decrypt_decode_supported(params)):
            return "host"
        mode = "device"
    if mode == "host" and not native_decode.decrypt_decode_supported(params):
        mode = "device"
    if mode == "device" and not device_decode.decode_supported(params):
        mode = "native"
    return mode


_decode_mode.python_fallbacks = 0


def _host_decrypt(params: PvwParameters, secret_key: SecretKey, c1, c2) -> list[int]:
    """The whole decryption of d messages on the host (mode ``host``): c1
    [k, d, L, l] and c2 [d, L, l], canonical int64 residue tensors on any
    device, laid out there and fetched once. Callers have checked
    ``native_decode.decrypt_decode_supported``."""
    def pairs(t):
        u = u64op.u64_numpy(t.contiguous())
        return (u >> np.uint64(32)).astype(np.uint32), u.astype(np.uint32)

    out = native_decode.decrypt_decode_pairs_native(
        secret_key.host_ntt_residues(), *pairs(c1), *pairs(c2), params)
    engine_calls.host += 1
    return out


def _decode_batch(residues: torch.Tensor, params: PvwParameters,
                  mode: str | None = None) -> list[int]:
    """Decode the messages of PowerBasis residues int64 [d, L, l] on any
    device by ``mode`` (default :func:`_decode_mode` with no batch size):
    on the residues' device, fetching the d messages alone (8 bytes each);
    in the C++ engine (``native``, and ``host`` on the backends, as in the
    JAX package); or by the Python decode. Where the engine does not cover
    the parameters (or ``no_native``), ``native`` takes the Python decode,
    counted in ``_decode_mode.python_fallbacks``."""
    mode = _decode_mode(params) if mode is None else mode
    if mode == "device":
        out = device_decode.decode_residues(device_decode.get_plan(params), residues)
        engine_calls.device += 1
        return [int(v) for v in u64op.u64_numpy(out)]
    res = u64op.u64_numpy(residues)
    if mode in ("host", "native"):
        if native_decode.decode_supported(params):
            out = native_decode.decode_batch_native(res, params)
            engine_calls.native += 1
            return out
        _decode_mode.python_fallbacks += 1
    engine_calls.python += 1
    return [decode_scalar_pvw_rns(res[i], params) for i in range(res.shape[0])]


def decrypt_party_value(ciphertext: PvwCiphertext, secret_key: SecretKey,
                        party_index: int) -> int:
    """Decrypt component ``party_index`` (``decryption.rs:249-278``): the
    span ``pvw.decrypt``, as :func:`decrypt_party_shares`."""
    with span("pvw.decrypt"):
        params = ciphertext.params
        with span("pvw.decrypt.select"):
            if not (0 <= party_index < params.n):
                raise InvalidParameters(
                    f"Party index {party_index} exceeds maximum {params.n - 1}"
                )
            c1 = ciphertext.c1.channel()[..., None]                      # [L, l, k, 1]
            c2 = ciphertext.c2.channel()[:, :, party_index][..., None]   # [L, l, 1]
        return _decrypt(params, secret_key, c1, c2)[0]


def _decrypt(params: PvwParameters, secret_key: SecretKey, c1, c2) -> list[int]:
    """Decrypt d messages, c1 [L, l, k, d] and c2 [L, l, d] channel-major,
    routed by :func:`_decode_mode` for the batch size d. Its stages are the
    spans ``pvw.decrypt.secret_key`` (the key's polynomials on c1's
    device), ``.contraction`` (:func:`_noisy_messages`) and ``.decode``
    (:func:`_decode_batch`, the answers on the host; the whole decryption
    in the ``host`` mode), which counts the engine."""
    mode = _decode_mode(params, c2.shape[-1])
    if mode == "host":
        with span("pvw.decrypt.decode", engine=mode):
            return _host_decrypt(params, secret_key, c1.permute(2, 3, 0, 1),
                                 c2.permute(2, 0, 1))
    with span("pvw.decrypt.secret_key"):
        sk = secret_key.to_polynomials(c1.device).res
    with span("pvw.decrypt.contraction"):
        z = _noisy_messages(params, sk, c1, c2)
    with span("pvw.decrypt.decode", engine=mode):
        return _decode_batch(z, params, mode)


def _party_columns(all_ciphertexts, party_index: int):
    """(params, c1 [L, l, k, n], c2 [L, l, n]): every dealer's columns for
    this party, channel-major, after the checks."""
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
        return params, ct.c1.channel(), ct.c2.channel()[:, :, party_index]
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
    return params, c1, c2


def decrypt_party_shares(all_ciphertexts, secret_key: SecretKey,
                         party_index: int) -> list[int]:
    """This party's share from every dealer ciphertext
    (``decryption.rs:281-325``): a list of n PvwCiphertexts, or one batched
    PvwCiphertext (c1 [k, d], c2 [n, d] with d = n). The call is the span
    ``pvw.decrypt``; the checks and the gather ``pvw.decrypt.select``, then
    :func:`_decrypt`'s."""
    with span("pvw.decrypt"):
        with span("pvw.decrypt.select"):
            params, c1, c2 = _party_columns(all_ciphertexts, party_index)
        return _decrypt(params, secret_key, c1, c2)
