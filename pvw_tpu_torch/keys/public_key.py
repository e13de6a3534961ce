"""Parties and the global public-key matrix B.

The counterpart of ``pvw_tpu.keys.public_key`` (the reference's
``public_key.rs``). B is one n x k Poly on the CRS's device. Batch key
generation is one fused scaled-digit matmul, b = sᵀA + e1, with the e1
NTT inside the kernel (:func:`_batch_keygen_kernel`); bounds above the
signed-digit range add residue noise after it, and bounds >= the smallest
modulus exact host-sampled noise (``generate_all_keys`` only).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..errors import InvalidParameters
from ..ops import modmat, ntt as ntt_ops, u64
from ..ops.fused_modmat import matmul_fold_scaled
from ..params.crs import PvwCrs
from ..params.parameters import PvwParameters
from ..poly import Poly, Representation
from ..sampling.uniform import sample_uniform_residues_host, sample_uniform_residues_rows
from .secret_key import SecretKey


def _batch_keygen_kernel(params: PvwParameters, a_res, coeffs, key,
                         coeff_bound: int, row_offset: int):
    """Public keys of a block of parties, b[p, i] = sum_j s[p, j]·A[j, i]
    + e1[p, i]. coeffs: int32 [p, k, l] CBD secrets of parties
    [row_offset, row_offset + p); a_res: A [k, k, L, l] (NTT). Returns
    [p, k, L, l]. e1 rows are keyed by global party index (stream v2), so
    any chunking gives the same values: signed digit planes in the fused
    matmul for bounds <= 32639, else residue noise added after it.
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
    noise = None if key is None else ntt_ops.noise_digit_planes(key, row_offset, p, k, l,
                                                                b1, dev)
    out = matmul_fold_scaled(sk_ch, a_scaled, ring, noise=noise, noise_bound=b1)
    if noise is None and key is not None:
        e1 = sample_uniform_residues_rows(key, row_offset, p, (k, l), b1, ring, dev)
        out = u64.addmod(out, ntt_ops.ntt_forward(e1, ring).permute(2, 3, 0, 1),
                         ring.table("q", dev).reshape(-1, 1, 1, 1))
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

    def get_index(self) -> int:
        return self.index

    def get_secret_key(self) -> SecretKey:
        return self.secret_key


class GlobalPublicKey:
    """The n x k matrix B of every party's key row (``public_key.rs:42-54``)."""

    def __init__(self, crs: PvwCrs) -> None:
        params = crs.params
        self.matrix = Poly.zero(params.ring, Representation.Ntt,
                                batch=(params.n, params.k), device=crs.device)
        self.crs = crs
        self.params = params
        self.num_keys = 0
        self._enc_ops = None

    @property
    def device(self):
        return self.crs.device

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
        from ..sampling.cbd import cbd_bound

        if coeffs.shape[0] > self.params.n:
            raise InvalidParameters(
                f"Too many secret keys: {coeffs.shape[0]} > {self.params.n}"
            )
        if self.params.error_bound_1 >= min(self.params.ring.moduli):
            # the JAX package's rule: the host-sampling path is
            # generate_all_keys' alone
            raise InvalidParameters(
                f"error_bound_1 {self.params.error_bound_1:#x} >= smallest "
                "modulus: device keygen unsupported, use generate_all_keys"
            )
        if coeff_bound is None:
            coeff_bound = cbd_bound(self.params.secret_variance)
        for b in (127, 32639):
            if coeff_bound <= b:
                coeff_bound = b
                break
        self._place_rows(self._products(coeffs.to(self.device), key, coeff_bound),
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
        """:func:`_batch_keygen_kernel` over party chunks -> [p, k, L, l]."""
        a_res = self.crs.matrix.res
        chunk = _keygen_chunk_size(self.params)
        parts = [
            _batch_keygen_kernel(self.params, a_res, coeffs[s:s + chunk],
                                 key, cb, s)
            for s in range(0, coeffs.shape[0], chunk)
        ]
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _place_rows(self, b, indices: list[int]) -> None:
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

    def __repr__(self) -> str:
        return (f"GlobalPublicKey(n={self.params.n}, k={self.params.k}, "
                f"num_keys={self.num_keys}, device={self.device})")
