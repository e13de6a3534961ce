"""RingPlan: the constant tables of R_q = Z_q[X]/(X^l + 1).

The counterpart of ``pvw_tpu.params.ring``, built by the same numpy code so
every table equals the JAX package's value for value. Where the JAX package
stores a u64 table as a (hi, lo) uint32 pair, this one stores the uint64
array itself (``pow_w`` for ``pow_hi``/``pow_lo`` and so on). Tensors for a
device come from :meth:`RingPlan.table`, cached per (name, device).

Polynomials are int64 residue tensors of shape ``[..., L, l]``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..config import settings
from ..errors import InvalidParameters
from ..ops import u64 as u64op
from ..utils.intmath import CrtBasis, primitive_root_of_unity, validate_ntt_modulus

# degree must be a power of two >= 8 (``parameters.rs:139-144``)
MIN_DEGREE = 8


def _digits_np(values: np.ndarray, nd: int = 8) -> np.ndarray:
    """Host signed digit decomposition of uint64 values -> int8 [..., nd].
    Exact iff every value satisfies ``value >> (8*(nd-1)) <= 126``
    (checked)."""
    v = values.astype(np.uint64)
    raw = np.stack(
        [((v >> np.uint64(8 * i)) & np.uint64(0xFF)).astype(np.int32) for i in range(nd)],
        axis=-1,
    )
    out = np.zeros_like(raw)
    carry = np.zeros(v.shape, np.int32)
    for i in range(nd):
        t = raw[..., i] + carry
        big = t >= 128
        out[..., i] = np.where(big, t - 256, t)
        carry = big.astype(np.int32)
    if np.any(carry) or np.any((v >> np.uint64(8 * (nd - 1))) > np.uint64(126)):
        raise ValueError(f"digit decomposition overflow for nd={nd}")
    return out.astype(np.int8)


def _band_lhs_np(dig: np.ndarray, jr: int | None = None) -> np.ndarray:
    """lhs digits [m, k, nd] int8 -> banded [(nd+jr-1)m, jr*k] with
    band[(c, m), (k, j)] = dig[m, k, c - j] for 0 <= c-j < nd, else 0, so
    one matmul against rhs digits [(k, j), n] yields the digit-convolution
    columns c-major."""
    m, k, nd = dig.shape
    if jr is None:
        jr = nd
    ncols = nd + jr - 1
    band = np.zeros((ncols, m, k, jr), np.int8)
    for c in range(ncols):
        for j in range(jr):
            d = c - j
            if 0 <= d < nd:
                band[c, :, :, j] = dig[:, :, d]
    return band.reshape(ncols * m, k * jr)


def _split_u64_pattern(values: np.ndarray) -> np.ndarray:
    """Python-int object array < 2^64 -> uint64 array."""
    return (values & np.uint64(0xFFFFFFFFFFFFFFFF)).astype(np.uint64)


@dataclass(frozen=True)
class LimbPlan:
    """Per-prime constants."""

    q: int
    psi: int                      # primitive 2l-th root of unity mod q
    ntt_fwd: np.ndarray           # uint64 [l, l]  W[j, i] = psi^(i*(2j+1))
    ntt_inv: np.ndarray           # uint64 [l, l]  includes the 1/l factor
    ntt_fwd_dig: np.ndarray       # int8 [l, l, nd]
    ntt_inv_dig: np.ndarray       # int8 [l, l, nd]


class RingPlan:
    """Immutable plan for one (moduli, degree) ring; equal and hashable by
    (moduli, degree, num_digits)."""

    def __init__(self, moduli: tuple[int, ...], degree: int) -> None:
        moduli = tuple(int(m) for m in moduli)
        if len(moduli) == 0:
            raise InvalidParameters("at least one modulus required")
        if len(set(moduli)) != len(moduli):
            raise InvalidParameters("moduli must be distinct")
        if degree < MIN_DEGREE or degree & (degree - 1):
            raise InvalidParameters(
                "l must be power of 2 and >= 8 (fhe.rs Context requirement)"
            )
        for q in moduli:
            validate_ntt_modulus(q, degree)

        self.moduli = moduli
        self.degree = int(degree)
        self.num_limbs = len(moduli)
        self.crt = CrtBasis(moduli)
        self.q_total = self.crt.q
        self._np_cache: dict = {}
        self._tensor_cache: dict = {}
        # one digit width for every limb: the minimal exact one, or the
        # width PVW_NUM_DIGITS forces (any exact width gives the same
        # residues; it selects the kernels' digit count)
        self.num_digits = max(u64op.digits_for_max(q - 1) for q in moduli)
        forced = settings.num_digits
        if forced:
            if forced < self.num_digits or forced > u64op.NUM_DIGITS:
                raise InvalidParameters(
                    f"PVW_NUM_DIGITS={forced} outside "
                    f"[{self.num_digits}, {u64op.NUM_DIGITS}]"
                )
            self.num_digits = forced
        self.num_columns = 2 * self.num_digits - 1
        self.limbs: list[LimbPlan] = [self._build_limb(q) for q in moduli]

        L, C = self.num_limbs, self.num_columns
        self.q = np.array(moduli, np.uint64)                        # [L]
        # fold tables: 2^(8c) mod q with 32- and 64-bit Shoup companions
        self.pow_w = np.zeros((L, C), np.uint64)
        self.pow_wp32 = np.zeros((L, C), np.uint32)
        pow_s64 = np.zeros((L, C), object)
        for i, q in enumerate(moduli):
            for c in range(C):
                w = pow(2, 8 * c, q)
                self.pow_w[i, c] = w
                self.pow_wp32[i, c] = (w << 32) // q
                pow_s64[i, c] = (w << 64) // q
        self.pow_s64 = _split_u64_pattern(pow_s64)
        # grouped fold: w_g = 2^(32g) mod q, 64-bit Shoup companions, and
        # the bias K = sum_c 2^31 * 2^(8c) mod q
        self.grp_w = np.zeros((L, 4), np.uint64)
        grp_s = np.zeros((L, 4), object)
        for i, q in enumerate(moduli):
            for g in range(4):
                w = pow(2, 32 * g, q)
                self.grp_w[i, g] = w
                grp_s[i, g] = (w << 64) // q
        self.grp_s = _split_u64_pattern(grp_s)
        self.bias = self.bias_for_columns(C)
        # word fold: 2^(32w) mod q for w = 1..4 with 32-bit Shoup companions
        # (valid only when every modulus exceeds 2^32)
        self.wrd_w = np.zeros((L, 4), np.uint64)
        self.wrd_wp32 = np.zeros((L, 4), np.uint32)
        for i, q in enumerate(moduli):
            for w in range(1, 5):
                v = pow(2, 32 * w, q)
                self.wrd_w[i, w - 1] = v
                self.wrd_wp32[i, w - 1] = (v << 32) // q
        self.fold_words_ok = all(q > (1 << 32) for q in moduli)
        self.ntt_fwd_dig = np.stack([lp.ntt_fwd_dig for lp in self.limbs])
        self.ntt_inv_dig = np.stack([lp.ntt_inv_dig for lp in self.limbs])
        self.ntt_fwd_band = np.stack([_band_lhs_np(lp.ntt_fwd_dig) for lp in self.limbs])
        self.ntt_inv_band = np.stack([_band_lhs_np(lp.ntt_inv_dig) for lp in self.limbs])

    def ntt_band_jr(self, direction: str, jr: int) -> np.ndarray:
        """Banded twiddle matrix for a ``jr``-digit rhs (the small-coefficient
        NTT path): int8 [L, (nd+jr-1)l, jr*l]."""
        key = (direction, jr)
        if key not in self._np_cache:
            digs = [lp.ntt_fwd_dig if direction == "fwd" else lp.ntt_inv_dig
                    for lp in self.limbs]
            self._np_cache[key] = np.stack([_band_lhs_np(d, jr) for d in digs])
        return self._np_cache[key]

    def ntt_scaled_tab(self, jr: int) -> np.ndarray:
        """Scaled-twiddle digit table of the fused noise NTT: int8
        [L, l(out s), l*jr, nd], entry (i, s, j*jr+dd, c) = signed digit c of
        ``fwd[s, j] * 2^(8*dd) mod q_i``. Contracting noise digit planes
        (row j*jr+dd for coefficient j, digit dd) against it adds NTT(noise)
        straight into the scaled-digit columns."""
        key = ("scaled-noise", jr)
        if key not in self._np_cache:
            l, nd = self.degree, self.num_digits
            out = np.zeros((self.num_limbs, l, l * jr, nd), np.int8)
            for i, lp in enumerate(self.limbs):
                q = lp.q
                for dd in range(jr):
                    scaled = np.zeros((l, l), np.uint64)
                    w = pow(2, 8 * dd, q)
                    for s in range(l):
                        for j in range(l):
                            scaled[s, j] = int(lp.ntt_fwd[s, j]) * w % q
                    out[i, :, dd::jr, :] = _digits_np(scaled, nd)
            self._np_cache[key] = out
        return self._np_cache[key]

    def bias_for_columns(self, ncols: int) -> np.ndarray:
        """Grouped-fold bias K = sum_{c<ncols} 2^31 * 2^(8c) mod q, uint64
        [L], for column tensors narrower than num_columns."""
        key = ("bias", ncols)
        if key not in self._np_cache:
            self._np_cache[key] = np.array(
                [sum((1 << 31) << (8 * c) for c in range(ncols)) % q
                 for q in self.moduli], np.uint64)
        return self._np_cache[key]

    def table(self, name: str, device, *args) -> torch.Tensor:
        """Table ``name`` as a tensor on ``device``, cached: u64 and u32
        tables as int64 (u64 entries as their bit patterns), int8 digit
        tables as int8. ``name`` is an attribute (``"q"``,
        ``"grp_w"``, ...) or, with ``args``, a method (``"ntt_scaled_tab"``,
        ``"bias_for_columns"``, ``"ntt_band_jr"``)."""
        def make(dev):
            src = getattr(self, name)
            arr = np.asarray(src(*args) if args else src)
            if arr.dtype == np.uint64:
                return u64op.u64_tensor(arr, dev)
            if arr.dtype == np.uint32:
                return torch.from_numpy(arr.astype(np.int64)).to(dev)
            return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)

        return self.cached((name, args), device, make)

    def cached(self, key, device, make):
        """``make(device)`` (tensors) for (``key``, device), made once per
        plan and device: the tables a kernel launch reads, so that a launch
        builds and uploads none."""
        dev = torch.device(device)
        if (key, dev) not in self._tensor_cache:
            self._tensor_cache[(key, dev)] = make(dev)
        return self._tensor_cache[(key, dev)]

    # -- construction helpers ------------------------------------------

    def _build_limb(self, q: int) -> LimbPlan:
        l = self.degree
        psi = primitive_root_of_unity(2 * l, q)
        inv_l = pow(l, -1, q)
        fwd = np.zeros((l, l), np.uint64)
        inv = np.zeros((l, l), np.uint64)
        for j in range(l):
            e = 2 * j + 1
            for i in range(l):
                fwd[j, i] = pow(psi, (e * i) % (2 * l), q)
        psi_inv = pow(psi, -1, q)
        for i in range(l):
            for j in range(l):
                e = 2 * j + 1
                inv[i, j] = inv_l * pow(psi_inv, (e * i) % (2 * l), q) % q
        return LimbPlan(
            q=q,
            psi=psi,
            ntt_fwd=fwd,
            ntt_inv=inv,
            ntt_fwd_dig=_digits_np(fwd, self.num_digits),
            ntt_inv_dig=_digits_np(inv, self.num_digits),
        )

    # -- identity ------------------------------------------------------

    def __hash__(self) -> int:
        return hash((self.moduli, self.degree, self.num_digits))

    def __eq__(self, other: object) -> bool:
        return (
            isinstance(other, RingPlan)
            and other.moduli == self.moduli
            and other.degree == self.degree
            and other.num_digits == self.num_digits
        )

    def __repr__(self) -> str:
        return (
            f"RingPlan(moduli={[hex(m) for m in self.moduli]}, "
            f"degree={self.degree}, num_digits={self.num_digits})"
        )

    # -- host packing helpers ------------------------------------------

    def residues_from_int_coeffs(self, coeffs) -> np.ndarray:
        """l Python-int coefficients (any magnitude, negatives allowed) ->
        uint64 residue matrix [L, l] (``parameters.rs:420-474``)."""
        if len(coeffs) != self.degree:
            raise InvalidParameters(
                f"Expected {self.degree} coefficients, got {len(coeffs)}"
            )
        out = np.zeros((self.num_limbs, self.degree), np.uint64)
        for col, c in enumerate(coeffs):
            c = int(c)
            for row, m in enumerate(self.moduli):
                out[row, col] = c % m
        return out

    def lift_to_ints(self, residues: np.ndarray) -> list[int]:
        """uint64 [L, l] residues -> l canonical coefficients in [0, q)."""
        res = np.asarray(residues, np.uint64)
        return [
            self.crt.lift(tuple(int(res[i, j]) for i in range(self.num_limbs)))
            for j in range(self.degree)
        ]


@lru_cache(maxsize=32)
def get_ring(moduli: tuple[int, ...], degree: int) -> RingPlan:
    """Memoized RingPlan constructor, keyed on (moduli, degree) as the JAX
    package's is: ``settings.num_digits`` applies to a plan built after it
    is set (``get_ring.cache_clear()`` makes the next call build anew)."""
    return RingPlan(tuple(moduli), degree)
