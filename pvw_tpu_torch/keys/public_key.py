"""Parties, one party's public key and the global public-key matrix B.

The counterpart of ``pvw_tpu.keys.public_key`` (the reference's
``public_key.rs``). B is one n x k Poly on the CRS's device. Batch key
generation is one fused scaled-digit matmul, b = sᵀA + e1, with the e1
NTT inside the kernel (:func:`_batch_keygen_kernel`); bounds above the
signed-digit range add residue noise after it, and bounds >= the smallest
modulus exact host-sampled noise (``generate_all_keys`` only). One party's
key (:class:`PublicKey`, :func:`_single_pk_kernel`) is the plain-torch
product sᵀA plus ``sample_error_1``'s errors, as the JAX package computes
it. Every change of B's rows installs a new tensor, so that the encryption
operands cached on its identity (:meth:`GlobalPublicKey._cached_operands`)
are remade.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import DimensionMismatch, InvalidParameters
from ..ops import modmat, ntt as ntt_ops
from ..ops.fused_modmat import matmul_fold_scaled, residue_noise_ch
from ..params.crs import PvwCrs
from ..params.parameters import PvwParameters
from ..poly import Poly, Representation
from ..sampling.uniform import sample_uniform_residues_host
from .secret_key import SecretKey


def _batch_keygen_kernel(params: PvwParameters, a_res, coeffs, key,
                         coeff_bound: int, row_offset: int):
    """Public keys of a block of parties, b[p, i] = sum_j s[p, j]·A[j, i]
    + e1[p, i]. coeffs: int32 [p, k, l] CBD secrets of parties
    [row_offset, row_offset + p); a_res: A [k, k, L, l] (NTT). Returns
    [p, k, L, l]. e1 rows are keyed by global party index (stream v2), so
    any chunking gives the same values: signed digit planes in the fused
    matmul for bounds <= 32639, else residue noise added in its epilogue
    (``post=``).
    ``key`` None gives sᵀA alone (the host keygen path adds its noise)."""
    ring = params.ring
    p, k, l = coeffs.shape
    dev = coeffs.device
    if ntt_ops.signed_digit_count(coeff_bound):
        sk_ch = ntt_ops.ntt_forward_signed_ch(coeffs, ring, coeff_bound)
    else:
        sk_ch = ntt_ops.ntt_forward(modmat.from_signed_coeffs(coeffs, ring),
                                    ring).permute(2, 3, 0, 1)
    a_scaled = modmat.prescale_digits_band(a_res.permute(2, 3, 0, 1), ring)
    b1 = params.error_bound_1
    noise = post = None
    if key is not None and ntt_ops.signed_digit_count(b1):
        noise = ntt_ops.noise_digit_planes(key, row_offset, p, k, l, b1, dev)
    elif key is not None:
        post = residue_noise_ch(key, row_offset, p, k, b1, ring, dev)
    out = matmul_fold_scaled(sk_ch, a_scaled, ring, noise=noise, noise_bound=b1, post=post)
    return out.permute(2, 3, 0, 1)                      # [p, k, L, l]


def _quantized_coeff_bound(coeffs: np.ndarray) -> int:
    """Bound bucket of the keygen kernel: 127 / 32639 / huge."""
    m = int(np.abs(coeffs.astype(np.int64)).max()) if coeffs.size else 0
    for b in (127, 32639):
        if m <= b:
            return b
    return 1 << 40


def _keygen_chunk_size(params: PvwParameters) -> int:
    """Parties per keygen call, so the largest intermediates stay within
    budget (the same rule as the JAX package)."""
    ring = params.ring
    S = ring.num_limbs * ring.degree
    per_party = S * params.k * (5 * ring.num_digits + 10)
    chunk = max(8, min(8192, modmat.COLS_BYTES_BUDGET // max(per_party, 1)))
    if chunk > 256:
        chunk -= chunk % 256
    return chunk


def _keygen_rows(params: PvwParameters, a_res, coeffs, key, cb: int, lo: int):
    """:func:`_batch_keygen_kernel` over chunks of the parties [lo, lo + p)
    (coeffs [p, k, l]), each chunk's e1 keyed by its global rows -> [p, k, L, l]."""
    chunk = _keygen_chunk_size(params)
    parts = [_batch_keygen_kernel(params, a_res, coeffs[s:s + chunk], key, cb, lo + s)
             for s in range(0, coeffs.shape[0], chunk)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _device_coeff_bound(params: PvwParameters, coeff_bound: int | None) -> int:
    """The keygen kernel's bound bucket (127 / 32639 / as given) of device
    keygen, the CBD bound of the variance by default; raises where
    error_bound_1 >= the smallest modulus (the host-sampling path is
    ``generate_all_keys``' alone, the JAX package's rule)."""
    from ..sampling.cbd import cbd_bound

    if params.error_bound_1 >= min(params.ring.moduli):
        raise InvalidParameters(
            f"error_bound_1 {params.error_bound_1:#x} >= smallest "
            "modulus: device keygen unsupported, use generate_all_keys"
        )
    if coeff_bound is None:
        coeff_bound = cbd_bound(params.secret_variance)
    return next((b for b in (127, 32639) if coeff_bound <= b), coeff_bound)


class Party:
    """A protocol participant: index + secret key (``public_key.rs:17-22``)."""

    def __init__(self, index: int, secret_key: SecretKey) -> None:
        self.index = index
        self.secret_key = secret_key

    @classmethod
    def new(cls, index: int, params: PvwParameters, key, device="cuda") -> "Party":
        """``public_key.rs:62-79``."""
        if index >= params.n:
            raise InvalidParameters(
                f"Party index {index} exceeds maximum {params.n - 1}"
            )
        return cls(index, SecretKey.random(params, key, device=device))

    def generate_public_key(self, crs: PvwCrs, key) -> "PublicKey":
        """b_i = s_iᵀA + e_i (``public_key.rs:85-92``)."""
        pk, _errors = PublicKey.generate(self.secret_key, crs, key)
        return pk

    def get_index(self) -> int:
        return self.index

    def get_secret_key(self) -> SecretKey:
        return self.secret_key


def _single_pk_kernel(params: PvwParameters, a_res, coeffs, key):
    """One party's b = sᵀA + e: the secret's NTT, the [1, k] x [k, k]
    product (``modmat.poly_matmul``), and e from ``sample_error_1(key,
    batch=(k,))`` (the threefry draw below the smallest modulus, the exact
    host draw above). Returns (b, e), NTT residues [k, L, l] on A's
    device."""
    dev = a_res.device
    ring = params.ring
    sk = Poly.from_coefficients(coeffs, ring, device=dev).to_ntt()
    sk_a = modmat.poly_matmul(sk.res[None], a_res, ring)[0]
    errors = params.sample_error_1(key, batch=(params.k,), device=dev)
    return modmat.poly_add(sk_a, errors.res, ring), errors.res


class PublicKey:
    """One party's k public-key polynomials (``public_key.rs:29-35``)."""

    def __init__(self, key_polynomials: Poly, params: PvwParameters) -> None:
        self.key_polynomials = key_polynomials     # Poly batch (k,), NTT
        self.params = params

    @classmethod
    def generate(cls, secret_key: SecretKey, crs: PvwCrs, key) -> tuple["PublicKey", Poly]:
        """b = sᵀA + e with e uniform in [-B1, B1]^l per component
        (``public_key.rs:111-147``), on the CRS's device. Returns
        (public_key, error_polys)."""
        if secret_key.params.k != crs.params.k:
            raise DimensionMismatch(crs.params.k, secret_key.params.k)
        params = secret_key.params
        b, e = _single_pk_kernel(params, crs.matrix.res,
                                 torch.from_numpy(secret_key.secret_coeffs), key)
        return (cls(Poly(b, Representation.Ntt, params.ring), params),
                Poly(e, Representation.Ntt, params.ring))

    def dimension(self) -> int:
        return self.key_polynomials.batch_shape[0]

    def get_polynomial(self, i: int) -> Optional[Poly]:
        if 0 <= i < self.dimension():
            return self.key_polynomials[i]
        return None

    def polynomials(self) -> Poly:
        return self.key_polynomials

    def validate(self) -> None:
        """``public_key.rs:168-187``."""
        if self.dimension() != self.params.k:
            raise InvalidParameters(
                f"Public key dimension {self.dimension()} doesn't match "
                f"parameter k={self.params.k}"
            )
        if self.key_polynomials.ring != self.params.ring:
            raise InvalidParameters("Public key polynomial context mismatch")

    def to_bytes(self) -> bytes:
        from ..utils.serialization import public_key_to_bytes
        return public_key_to_bytes(self)

    @classmethod
    def from_bytes(cls, data: bytes, device="cuda") -> "PublicKey":
        from ..utils.serialization import public_key_from_bytes
        return public_key_from_bytes(data, device=device)


class PublicKeyRows:
    """Rows [lo, hi) of the global public key B, made and held without the
    other rows: one recv row's block of a mesh across processes. Batch
    keygen of the range from the range's own secret coefficients, e1 keyed
    by global row, so the rows are byte for byte the same rows of
    :class:`GlobalPublicKey`'s matrix. :meth:`encrypt_operands` gives a
    shard's operands: the digit planes of a k-column block of the rows, and
    of A."""

    def __init__(self, crs: PvwCrs, lo: int, rows: torch.Tensor) -> None:
        params = crs.params
        hi = lo + rows.shape[0]
        if not 0 <= lo < hi <= params.n or tuple(rows.shape[1:]) != (
                params.k, params.ring.num_limbs, params.ring.degree):
            raise InvalidParameters(
                f"rows [{lo}, {hi}) of shape {tuple(rows.shape)}: not a block of "
                f"the n={params.n} x k={params.k} key")
        self.crs, self.params, self.lo, self.hi = crs, params, lo, hi
        self.matrix = Poly(rows, Representation.Ntt, params.ring)    # batch (hi - lo, k)

    @classmethod
    def generate_device(cls, crs: PvwCrs, coeffs: torch.Tensor, key, lo: int,
                        coeff_bound: int | None = None) -> "PublicKeyRows":
        """Keys of the parties [lo, lo + p) from their secret coefficients
        (int32 [p, k, l]), as :meth:`GlobalPublicKey.generate_all_keys_device`
        makes those rows (``coeff_bound`` likewise)."""
        params = crs.params
        cb = _device_coeff_bound(params, coeff_bound)
        return cls(crs, lo, _keygen_rows(params, crs.matrix.res, coeffs.to(crs.device), key,
                                         cb, lo).contiguous())

    def encrypt_operands(self, k_block: tuple[int, int] | None = None,
                         with_a: bool = False):
        """(A's planes or None, B's planes) over the k columns ``k_block`` =
        (first, count) (default all k): channel-major int8 digit planes
        [L, l, k, count*nd] of A (with ``with_a``) and [L, l, hi - lo,
        count*nd] of these rows, k-major and digit-minor, laid out for the
        Hopper kernels (:func:`~pvw_tpu_torch.ops.modmat.k_rows`); the same
        bytes as that block of columns of :meth:`GlobalPublicKey.
        encrypt_operands`. Made at each call."""
        c0, kc = (0, self.params.k) if k_block is None else k_block
        ring = self.params.ring

        def planes(x):
            return modmat.k_rows(modmat.lhs_digit_planes(x[:, c0:c0 + kc].contiguous(), ring))

        return (planes(self.crs.matrix.res) if with_a else None), planes(self.matrix.res)


class GlobalPublicKey:
    """The n x k matrix B of every party's key row (``public_key.rs:42-54``)."""

    def __init__(self, crs: PvwCrs) -> None:
        params = crs.params
        self.matrix = Poly.zero(params.ring, Representation.Ntt,
                                batch=(params.n, params.k), device=crs.device)
        self.crs = crs
        self.params = params
        self.num_keys = 0
        # error_polynomials[party] -> Poly (k,) | None (``public_key.rs:52-53``)
        self.error_polynomials: list[Optional[Poly]] = []
        self._enc_ops = None

    @property
    def device(self):
        return self.crs.device

    # -- one party at a time ---------------------------------------------

    def add_public_key(self, index: int, public_key: PublicKey) -> None:
        """``public_key.rs:214-250``: row ``index`` of B, into a new tensor.
        ``num_keys`` tracks max(index) + 1, not a count (the reference's
        quirk)."""
        if index >= self.params.n:
            raise InvalidParameters(
                f"Party index {index} exceeds maximum {self.params.n - 1}"
            )
        public_key.validate()
        if public_key.params.k != self.params.k:
            raise InvalidParameters(
                f"Public key dimension {public_key.params.k} doesn't match "
                f"global key dimension {self.params.k}"
            )
        self._place_rows(public_key.key_polynomials.res.to(self.device)[None], [index])

    def generate_and_add_party(self, party: Party, key) -> None:
        """``public_key.rs:256-263``."""
        self.add_public_key(party.index, party.generate_public_key(self.crs, key))

    def generate_and_add(self, index: int, secret_key: SecretKey, key) -> None:
        """``public_key.rs:269-277``."""
        pk, _errors = PublicKey.generate(secret_key, self.crs, key)
        self.add_public_key(index, pk)

    def generate_and_add_with_errors(self, index: int, secret_key: SecretKey, key) -> None:
        """``public_key.rs:304-320``: also records the error polynomials,
        for external PVSS proofs."""
        pk, errors = PublicKey.generate(secret_key, self.crs, key)
        self.add_public_key(index, pk)
        while len(self.error_polynomials) <= index:
            self.error_polynomials.append(None)
        self.error_polynomials[index] = errors

    def generate_and_add_party_with_errors(self, party: Party, key) -> None:
        """``public_key.rs:322-328``."""
        self.generate_and_add_with_errors(party.index, party.secret_key, key)

    # -- batch keygen ------------------------------------------------------

    def generate_all_party_keys(self, parties: list[Party], key) -> None:
        """All parties' b_i = s_iᵀA + e_i in one batched product
        (``public_key.rs:376-401``)."""
        if len(parties) > self.params.n:
            raise InvalidParameters(
                f"Too many parties: {len(parties)} > {self.params.n}"
            )
        self._batch_generate([p.secret_key for p in parties],
                             [p.index for p in parties], key)

    def generate_all_keys(self, secret_keys: list[SecretKey], key) -> None:
        """``public_key.rs:407-434``: indices assigned in order."""
        if len(secret_keys) > self.params.n:
            raise InvalidParameters(
                f"Too many secret keys: {len(secret_keys)} > {self.params.n}"
            )
        self._batch_generate(secret_keys, list(range(len(secret_keys))), key)

    def generate_all_keys_device(self, coeffs: torch.Tensor, key,
                                 coeff_bound: int | None = None) -> None:
        """Batch keygen from device-resident secret coefficients (int32
        [p, k, l], p <= n, indices 0..p-1): the same values as
        :meth:`generate_all_keys` on SecretKeys of those coefficients.
        ``coeff_bound`` defaults to the CBD bound of the variance."""
        if coeffs.shape[0] > self.params.n:
            raise InvalidParameters(
                f"Too many secret keys: {coeffs.shape[0]} > {self.params.n}"
            )
        cb = _device_coeff_bound(self.params, coeff_bound)
        self._place_rows(self._products(coeffs.to(self.device), key, cb),
                         list(range(coeffs.shape[0])))

    def _batch_generate(self, secret_keys: list[SecretKey], indices: list[int],
                        key) -> None:
        params = self.params
        coeffs = np.stack([sk.secret_coeffs for sk in secret_keys])
        ct = torch.from_numpy(coeffs).to(self.device)
        cb = _quantized_coeff_bound(coeffs)
        if params.error_bound_1 < min(params.ring.moduli):
            self._place_rows(self._products(ct, key, cb), indices)
            return
        # huge bound (>= min q): sᵀA on the card, then exact host-sampled
        # errors over the whole batch (``public_key.py:360-368``)
        e = sample_uniform_residues_host(key, (len(secret_keys), params.k, params.l),
                                         params.error_bound_1, params.ring, self.device)
        b = modmat.poly_add(self._products(ct, None, cb),
                            ntt_ops.ntt_forward(e, params.ring), params.ring)
        self._place_rows(b, indices)

    def _products(self, coeffs, key, cb: int):
        """:func:`_keygen_rows` from row 0 -> [p, k, L, l]."""
        return _keygen_rows(self.params, self.crs.matrix.res, coeffs, key, cb, 0)

    def _place_rows(self, b, indices: list[int]) -> None:
        """Rows ``indices`` of B set to ``b``, in a new tensor."""
        if indices == list(range(self.params.n)):
            res = b.contiguous()
        else:
            res = self.matrix.res.clone()
            res[torch.as_tensor(indices, device=res.device)] = b
        self.matrix = Poly(res, Representation.Ntt, self.params.ring)
        for i in indices:
            if i >= self.num_keys:
                self.num_keys = i + 1

    def _cached_operands(self, make):
        """(make(A), make(B)) of the current matrices, in one cache slot:
        remade when either matrix or ``make`` changes, so the banded and the
        swapped operand sets are never resident together. Their k*nd rows
        get the 16-byte pitch the Hopper kernels read through TMA
        (:func:`~pvw_tpu_torch.ops.modmat.k_rows`: zero-padded views where
        k*nd is not a multiple of 16), once, here."""
        key = (make, self.crs.matrix.res, self.matrix.res)
        if self._enc_ops is None or any(a is not b for a, b in zip(self._enc_ops[0], key)):
            self._enc_ops = None                      # drop the old set before making the new
            self._enc_ops = (key, tuple(modmat.k_rows(make(x, self.params.ring))
                                        for x in key[1:]))
        return self._enc_ops[1]

    def encrypt_operands(self):
        """Cached channel-major digit planes of (A, B), int8
        [L, l, k, k*nd] / [L, l, n, k*nd]: the encryption-invariant lhs
        operands of the fused kernel, remade when either matrix changes."""
        return self._cached_operands(modmat.lhs_digit_planes)

    def encrypt_operands_swapped(self):
        """Cached scaled channel-major digit planes of (A, B), int8
        [L, l, nd, k, k*nd] / [L, l, nd, n, k*nd]
        (:func:`~pvw_tpu_torch.ops.modmat.lhs_scaled_planes`): the lhs
        operands of the swapped form, nd times the bytes of
        :meth:`encrypt_operands`; the same invalidation rule, and the same
        cache slot, so asking for one form drops the other."""
        return self._cached_operands(modmat.lhs_scaled_planes)

    def get_public_key(self, index: int) -> Optional[PublicKey]:
        """``public_key.rs:283-301``."""
        if index >= self.num_keys:
            return None
        return PublicKey(self.matrix[index], self.params)

    def get_polynomial(self, i: int, j: int) -> Optional[Poly]:
        if 0 <= i < self.params.n and 0 <= j < self.params.k:
            return self.matrix[i, j]
        return None

    def dimensions(self) -> tuple[int, int]:
        return (self.params.n, self.params.k)

    def num_public_keys(self) -> int:
        return self.num_keys

    def is_full(self) -> bool:
        """``public_key.rs:349-351``."""
        return self.num_keys >= self.params.n

    def get_crs(self) -> PvwCrs:
        return self.crs

    def validate(self) -> None:
        """``public_key.rs:361-370``."""
        shape = self.matrix.batch_shape
        if shape != (self.params.n, self.params.k):
            raise InvalidParameters(
                f"Global public key matrix dimensions {shape[0]}×{shape[1]} "
                f"don't match parameters n={self.params.n}, k={self.params.k}"
            )

    def get_party_polynomials(self, party_index: int) -> Poly:
        """``public_key.rs:440-459``."""
        if party_index >= self.num_keys:
            raise InvalidParameters(f"Party index {party_index} not found")
        return self.matrix[party_index]

    def get_party_errors(self, party_index: int) -> Optional[Poly]:
        if 0 <= party_index < len(self.error_polynomials):
            return self.error_polynomials[party_index]
        return None

    def get_all_errors(self) -> list[Optional[Poly]]:
        return self.error_polynomials

    def __repr__(self) -> str:
        return (f"GlobalPublicKey(n={self.params.n}, k={self.params.k}, "
                f"num_keys={self.num_keys}, device={self.device})")

    def to_bytes(self) -> bytes:
        from ..utils.serialization import global_public_key_to_bytes
        return global_public_key_to_bytes(self)

    @classmethod
    def from_bytes(cls, data: bytes, device="cuda") -> "GlobalPublicKey":
        from ..utils.serialization import global_public_key_from_bytes
        return global_public_key_from_bytes(data, device=device)
