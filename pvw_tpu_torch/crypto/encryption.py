"""PVW encryption: vector, share-distribution and broadcast modes.

The counterpart of ``pvw_tpu.crypto.encryption`` (the reference's
``encryption.rs``): c1 = A·r + e1, c2 = B·r + e2 + encode(m), batched over
d independent encryptions so both products are one fused scaled-digit
matmul each (:func:`~pvw_tpu_torch.ops.fused_modmat.matmul_fold_scaled`),
with the noise NTT and the gadget encode inside the kernel. On a card the
r-stage (signed NTT + scaled-digit band) is one kernel too
(:func:`~pvw_tpu_torch.ops.fused_modmat.ntt_prescale_band`). Two opt-in
forms of the products, as in the JAX package: ``settings.swapped_form``
(:func:`_swapped_form_ok`: the scales on the cached key planes, kernel 1's
swapped variant) and ``settings.pipeline_fold`` (the pipelined kernel).

Randomness is counter-based: the same key gives the same ciphertexts as
the JAX package on the CPU. Stream routing follows the JAX package:
``"kernel"``/``"v4"`` and ``"v3"`` draw v3 noise planes (v4's hardware
PRNG exists only on a TPU), ``"v3k"`` generates v3k planes (``gen_noise``;
the v3k kernel on a card) and draws the cbd-k r stream. Bounds above the
signed-digit range (> 32639) add row-keyed residue noise after the fused
matmul, and bounds >= the smallest modulus exact host-sampled noise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import InvalidParameters
from ..keys.public_key import GlobalPublicKey
from ..ops import modmat, ntt as ntt_ops, u64 as u64op
from ..ops.fused_modmat import (encode_tab, gen_noise_planes, kernel_noise_available,
                                matmul_fold_scaled, matmul_fold_swapped,
                                ntt_prescale_band, pipeline_takes)
from ..ops.tfry import key_words as tfry_key_words
from ..params.parameters import PvwParameters
from ..poly import Poly, Representation
from ..random import split
from ..sampling.cbd import cbd_bound, sample_vec_cbd_rows
from ..sampling.uniform import sample_uniform_residues_host, sample_uniform_residues_rows
from ..utils.profiling import span


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

    def is_empty(self) -> bool:
        return self.c1.batch_shape[0] == 0 and self.c2.batch_shape[0] == 0

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

    def c1_components(self) -> Poly:
        return self.c1

    def c2_components(self) -> Poly:
        return self.c2

    def __repr__(self) -> str:
        return f"PvwCiphertext(k={self.c1.batch_shape}, n={self.c2.batch_shape})"

    def to_bytes(self) -> bytes:
        from ..utils.serialization import ciphertext_to_bytes
        return ciphertext_to_bytes(self)

    @classmethod
    def from_bytes(cls, data: bytes, device="cuda") -> "PvwCiphertext":
        from ..utils.serialization import ciphertext_from_bytes
        return ciphertext_from_bytes(data, device=device)


def _run(name: str, fn):
    """The default stage hook: run the stage in the span
    ``pvw.encrypt.<name>``."""
    with span(f"pvw.encrypt.{name}"):
        return fn()


def _r_operand(params: PvwParameters, k_r, d: int, stream: str | None, col_off: int,
               device, swapped: bool = False, stage=_run):
    """The r-stage: CBD coefficients [k, d, l] (the cbd-k stream under v3k,
    else row-keyed) -> scaled-digit band int8 [L, l, nd, k*nd, d] through
    :func:`ntt_prescale_band` (the kernel on a card, its twin on the CPU);
    for the ``swapped`` form the plain digits int8 [L, l, k*nd, d] of the
    signed NTT (``ntt_forward_signed_ch`` + ``rhs_digit_cols``, plain
    torch, as the JAX package leaves them to XLA)."""
    k, l, var = params.k, params.l, params.secret_variance
    if stream == "v3k":
        from ..ops import tfry

        r = stage("r_sample_v3k", lambda: tfry.v3k_cbd_values(
            *tfry.key_words(k_r), 0, k, d, l, var, col_off, device))
    else:
        r = stage("r_sample", lambda: sample_vec_cbd_rows(k_r, 0, k, (d, l), var, device))
    if swapped:
        return stage("r_ntt_digits", lambda: modmat.rhs_digit_cols(
            ntt_ops.ntt_forward_signed_ch(r, params.ring, cbd_bound(var)), params.ring))
    return stage("r_ntt_prescale_kernel",
                 lambda: ntt_prescale_band(r, params.ring, cbd_bound(var)))


def _gen_noise(kk, bound: int, stream: str | None, col_off: int, device):
    """(seeds, jr, bound, "tfry") for the v3k generator, or None."""
    if stream != "v3k" or not kernel_noise_available(bound, tfry=True, device=device):
        return None
    return ((*tfry_key_words(kk), 0, col_off), ntt_ops.signed_digit_count(bound),
            int(bound), "tfry")


def _product(params: PvwParameters, r_op, lhs_dig, kk, rows: int, bound: int,
             stream: str | None, host_e=None, encode=None, encode32: bool = False,
             col_off: int = 0, stage=_run):
    """One noisy product lhs·r + e (+ encode(sc)·g) -> channel-major
    [L, l, rows, d], with the JAX package's noise routing
    (``encryption.py:190-316``): a bound with signed digits under v3k takes
    ``gen_noise`` (the v3k kernel on a card, launched ahead of the fused
    matmul, which reads its planes, or drawn inside the pipelined kernel
    where it runs, :func:`~pvw_tpu_torch.ops.fused_modmat.pipeline_takes`),
    under v4 and v3 it draws v3 planes; larger bounds run the fused matmul
    without noise rows and add residue noise (row-keyed, stream v2) or
    ``host_e`` after it. A 5-D ``lhs_dig`` (scaled planes) takes the
    swapped form, :func:`matmul_fold_swapped`, with ``r_op`` the plain
    digits of r. ``stage(name, fn)`` runs each step: "noise_gen" or
    "noise", "kernel", then "noise_residues" and "addmod" where the noise
    comes after."""
    ring, l = params.ring, params.l
    d, dev = r_op.shape[-1], r_op.device

    def kernel(planes, noise_bound, gen_noise=None):
        if lhs_dig.ndim == 5:
            return stage("kernel", lambda: matmul_fold_swapped(
                lhs_dig, r_op, ring, noise=planes, encode=encode, encode32=encode32,
                noise_bound=noise_bound))
        return stage("kernel", lambda: matmul_fold_scaled(
            None, r_op, ring, noise=planes, encode=encode, lhs_dig=lhs_dig,
            encode32=encode32, gen_noise=gen_noise, noise_bound=noise_bound))

    g = None if host_e is not None else _gen_noise(kk, bound, stream, col_off, dev)
    if g is not None and lhs_dig.ndim == 4 and pipeline_takes(dev):
        return kernel(None, None, gen_noise=g)
    if g is not None:
        return kernel(stage("noise_gen", lambda: gen_noise_planes(g, rows, d, l, dev)),
                      g[2])
    if host_e is None and ntt_ops.signed_digit_count(bound):
        return kernel(stage("noise", lambda: ntt_ops.noise_digit_planes(
            kk, 0, rows, d, l, bound, dev)), bound)
    c = kernel(None, None)
    if host_e is None:
        host_e = stage("noise_residues", lambda: ntt_ops.ntt_forward(
            sample_uniform_residues_rows(kk, 0, rows, (d, l), bound, ring, dev),
            ring).permute(2, 3, 0, 1))
    q = ring.table("q", dev).reshape(-1, 1, 1, 1)
    return stage("addmod", lambda: u64op.addmod(c, host_e, q))


def _encode_table(params: PvwParameters, dev) -> torch.Tensor:
    """The encode table on ``dev``. Its copy from pageable memory syncs the
    stream, so the host waits there for c1's product: the copy is the span
    ``pvw.encrypt.encode_table.upload``, apart from the table's host work."""
    tab = encode_tab(params.gadget_ntt, params.gadget_ntt_shoup, params.gadget_wrap)
    with span("pvw.encrypt.encode_table.upload"):
        return u64op.u64_tensor(tab, dev)


def _encrypt_kernel(params: PvwParameters, a_dig, b_dig, sc, key,
                    encode32: bool = False, host_e1=None, host_e2=None,
                    stream: str | None = "v4", col_off: int = 0, stage=_run):
    """d-batched PVW encryption. a_dig int8 [L, l, k, k*nd] and b_dig int8
    [L, l, n, k*nd] are the cached lhs planes, or the swapped form's scaled
    planes [L, l, nd, k|n, k*nd]; sc int64 [d, n] are the u64
    scalars (bit patterns); ``encode32``: all scalars < 2^32;
    ``host_e1``/``host_e2``: NTT-domain channel-major noise [L, l, rows, d]
    sampled on the host (:func:`_host_noise_pairs`) for bounds >= the
    smallest modulus, or None; ``stream``: "v4", "v3k" or None (v3), from
    ``settings.kernel_noise_stream()``; ``stage(name, fn)``: runs each step
    (:func:`_r_operand`, then :func:`_product` for c1 and c2, their names
    suffixed ``_c1``/``_c2``, and "encode_table" between them), a hook for
    timing them. Returns
    channel-major c1 [L, l, k, d] and c2 [L, l, n, d]."""
    k_r, k_e1, k_e2 = split(key, 3)
    dev = sc.device
    r_op = _r_operand(params, k_r, sc.shape[0], stream, col_off, dev, a_dig.ndim == 5,
                      stage)
    c1 = _product(params, r_op, a_dig, k_e1, params.k, params.error_bound_1, stream,
                  host_e1, col_off=col_off,
                  stage=lambda name, fn: stage(f"{name}_c1", fn))
    etab = stage("encode_table", lambda: _encode_table(params, dev))
    c2 = _product(params, r_op, b_dig, k_e2, params.n, params.error_bound_2, stream,
                  host_e2, (sc.t().contiguous(), etab), encode32, col_off,
                  stage=lambda name, fn: stage(f"{name}_c2", fn))
    return c1, c2


def _host_noise_ch(kk, rows: int, d: int, bound: int, params: PvwParameters, device):
    """Exact host sampling of uniform noise in [-bound, bound] for bounds
    >= the smallest modulus, as NTT-domain channel-major residues
    [L, l, rows, d] ready to add after the fused matmul. Deterministic in
    ``kk``."""
    e = sample_uniform_residues_host(kk, (rows, d, params.l), bound, params.ring, device)
    return ntt_ops.ntt_forward(e, params.ring).permute(2, 3, 0, 1)


def _host_noise_pairs(params: PvwParameters, key, d: int, device, min_q: int | None = None):
    """(host_e1, host_e2) for :func:`_encrypt_kernel`: non-None only for the
    bounds the device samplers cannot embed (>= min(q_i)). Splits ``key``
    as the kernel does, so the host draw takes the stream slot the device
    draw would have. ``min_q``: the routing threshold; limb shards pass the
    full ring's smallest modulus, so each makes the full ring's choice."""
    if min_q is None:
        min_q = min(params.ring.moduli)
    if max(params.error_bound_1, params.error_bound_2) < min_q:
        return None, None
    _, k_e1, k_e2 = split(key, 3)
    host_e1 = host_e2 = None
    if params.error_bound_1 >= min_q:
        host_e1 = _host_noise_ch(k_e1, params.k, d, params.error_bound_1, params, device)
    if params.error_bound_2 >= min_q:
        host_e2 = _host_noise_ch(k_e2, params.n, d, params.error_bound_2, params, device)
    return host_e1, host_e2


def _encode_channel_major(params: PvwParameters, sc):
    """Gadget encode of u64 scalars sc int64 [d, n] (bit patterns) ->
    residues [L, l, n, d], with the ``as i64`` wrap of scalars >= 2^63
    (``encryption.rs:195``): what the kernel's epilogue adds, as a tensor
    (the sharded path's bake route adds it to a row block)."""
    ring = params.ring
    dev = sc.device
    L = ring.num_limbs
    q = ring.table("q", dev).reshape(L, 1, 1, 1)
    tab = lambda t: u64op.u64_tensor(t, dev)[:, :, None, None]
    x = sc.t()[None, None]
    e = u64op.shoup_mul64_arr(x, tab(params.gadget_ntt), tab(params.gadget_ntt_shoup), q)
    return torch.where(x < 0, u64op.submod(e, tab(params.gadget_wrap), q), e)


def _swapped_form_ok(params: PvwParameters, d: int) -> bool:
    """Encrypt in the swapped operand form: ``settings.swapped_form`` on,
    d >= 128 dealers, and both error bounds with signed digits (so no
    residue or host noise), as in the JAX package (``encryption.py:391-412``).
    The same rule on a card and on the CPU, which takes the twin. The JAX
    package's further conditions describe Mosaic alone and are dropped: its
    VMEM tile model (``_pick_tiles_swapped``) and its compile cap (nd >= 8
    with n > 256), without which no deep chain could take the form."""
    from ..config import settings

    return (bool(settings.swapped_form) and d >= 128
            and bool(ntt_ops.signed_digit_count(params.error_bound_1))
            and bool(ntt_ops.signed_digit_count(params.error_bound_2)))


def _checked_scalars(all_scalars, global_pk: GlobalPublicKey):
    """The scalars as uint64 [d, n], checked against the key and the
    parameters, and whether all are < 2^32."""
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
    # one max over the scalars: no shifted copy of a 4096 x 4096 array
    return arr, int(arr.max(initial=0)) < 1 << 32


def encrypt_batch(all_scalars, global_pk: GlobalPublicKey, key) -> PvwCiphertext:
    """Encrypt d scalar vectors ([d, n] u64) in one call: c1 [k, d],
    c2 [n, d], on the key matrix's device. The call is the span
    ``pvw.encrypt``; its stages ``pvw.encrypt.checks``, ``.upload``, the
    kernel's stages (:func:`_run`) and ``.wrap``."""
    from ..config import settings

    with span("pvw.encrypt"):
        params = global_pk.params
        with span("pvw.encrypt.checks"):
            arr, encode32 = _checked_scalars(all_scalars, global_pk)
        with span("pvw.encrypt.upload", dealers=arr.shape[0], bytes=arr.nbytes):
            sc = u64op.u64_tensor(arr, global_pk.device)
        # bounds >= min(q_i): exact host sampling (the reference's BigInt path
        # accepts any bound, encryption.rs:161-173)
        host_e1, host_e2 = _host_noise_pairs(params, key, arr.shape[0], sc.device)
        if host_e1 is None and host_e2 is None and _swapped_form_ok(params, arr.shape[0]):
            a_dig, b_dig = global_pk.encrypt_operands_swapped()
        else:
            a_dig, b_dig = global_pk.encrypt_operands()
        c1, c2 = _encrypt_kernel(params, a_dig, b_dig, sc, key, encode32, host_e1, host_e2,
                                 settings.kernel_noise_stream())
        with span("pvw.encrypt.wrap"):
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
