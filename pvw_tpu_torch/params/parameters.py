"""PVW parameters: builder, Δ, gadget tables, correctness condition.

The counterpart of ``pvw_tpu.params.parameters`` (the reference's
``parameters.rs``). Host-side, once per deployment; what the device needs
are the precomputed tables:

- ``gadget_ntt`` / ``gadget_ntt_shoup``: the NTT-domain gadget g(X) =
  Σ Δ^i X^i per limb with 64-bit Shoup companions, so the encode ``m · g``
  is one constant multiply per slot;
- ``gadget_wrap`` / ``gadget_wrap_shoup``: (2^64 mod q) · g, subtracted
  when the reference's ``scalars[i] as i64`` cast (``encryption.rs:195``)
  makes a u64 scalar >= 2^63 negative.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from ..errors import EncodingError, InvalidParameters, SamplingError, SerializationError
from ..utils.intmath import integer_nth_root
from .ring import RingPlan, _digits_np, get_ring


def _to_f64(x: int) -> float:
    """num-traits ``to_f64`` semantics: saturate to +/-inf, never fail."""
    try:
        return float(x)
    except OverflowError:
        return math.inf if x > 0 else -math.inf


class PvwParameters:
    """Scheme parameters (``parameters.rs:19-40``): n parties, t =
    (n-1)//2 (stored, unused -- the reference's quirk), k, l,
    secret_variance, error_bound_1/2, the ring plan, Δ = ⌊q^(1/l)⌋ and
    Δ^(l-1)."""

    def __init__(self, n: int, k: int, l: int, moduli: tuple[int, ...],
                 secret_variance: float, error_bound_1: int,
                 error_bound_2: int) -> None:
        if n == 0:
            raise InvalidParameters("n must be > 0")
        if k == 0:
            raise InvalidParameters("k must be > 0")
        if l < 8 or (l & (l - 1)) != 0:
            raise InvalidParameters(
                "l must be power of 2 and >= 8 (fhe.rs Context requirement)"
            )
        try:
            ring = get_ring(tuple(int(m) for m in moduli), l)
        except InvalidParameters as e:
            raise InvalidParameters(f"Context creation failed: {e}") from e
        if int(error_bound_1) <= 0:
            raise InvalidParameters("error_bound_1 must be positive")
        if int(error_bound_2) <= 0:
            raise InvalidParameters("error_bound_2 must be positive")

        self.n = int(n)
        self.t = (self.n - 1) // 2
        self.k = int(k)
        self.l = int(l)
        self.secret_variance = float(secret_variance)
        self.error_bound_1 = int(error_bound_1)
        self.error_bound_2 = int(error_bound_2)
        self.ring: RingPlan = ring
        self._q_total = ring.q_total
        self._delta = integer_nth_root(self._q_total, l)
        self._delta_pow = self._delta ** (l - 1)
        self._build_gadget_tables()

    @staticmethod
    def builder() -> "PvwParametersBuilder":
        return PvwParametersBuilder()

    @classmethod
    def new(cls, n, k, l, moduli, secret_variance, error_bound_1, error_bound_2):
        """``parameters.rs:210-228``."""
        return cls(n, k, l, tuple(moduli), secret_variance,
                   int(error_bound_1), int(error_bound_2))

    @classmethod
    def new_with_u32_bounds(cls, n, k, l, moduli, secret_variance,
                            error_bound_1, error_bound_2):
        """``parameters.rs:231-249``."""
        return cls.new(n, k, l, moduli, secret_variance,
                       int(error_bound_1), int(error_bound_2))

    def _build_gadget_tables(self) -> None:
        ring = self.ring
        L, l = ring.num_limbs, ring.degree
        g_res = ring.residues_from_int_coeffs(self.gadget_vector())
        g_ntt = np.zeros((L, l), np.uint64)
        g_wrap = np.zeros((L, l), np.uint64)
        g_ntt_sh = np.zeros((L, l), np.uint64)
        g_wrap_sh = np.zeros((L, l), np.uint64)
        for i, lp in enumerate(ring.limbs):
            q = lp.q
            wrap = pow(2, 64, q)
            for j in range(l):
                v = sum(int(lp.ntt_fwd[j, c]) * int(g_res[i, c])
                        for c in range(l)) % q
                g_ntt[i, j] = v
                g_ntt_sh[i, j] = (v << 64) // q
                w = v * wrap % q
                g_wrap[i, j] = w
                g_wrap_sh[i, j] = (w << 64) // q
        self.gadget_ntt = g_ntt
        self.gadget_ntt_shoup = g_ntt_sh
        self.gadget_wrap = g_wrap
        self.gadget_wrap_shoup = g_wrap_sh
        self.gadget_ntt_dig = _digits_np(g_ntt, ring.num_digits)

    # -- cached values ---------------------------------------------------

    def delta(self) -> int:
        """Δ = ⌊q^(1/l)⌋ (``parameters.rs:370``)."""
        return self._delta

    def delta_power_l_minus_1(self) -> int:
        """Δ^(l-1) (``parameters.rs:375``)."""
        return self._delta_pow

    def q_total(self) -> int:
        """q = ∏ q_i (``parameters.rs:380-386``)."""
        return self._q_total

    def moduli(self) -> tuple[int, ...]:
        return self.ring.moduli

    def rns_context(self):
        """The CRT basis (``params.rns_context()``)."""
        return self.ring.crt

    def ntt_operators(self):
        """The per-limb NTT plans (``params.ntt_operators()``)."""
        return self.ring.limbs

    # -- sampling shortcuts (``parameters.rs:252-284``) ------------------

    def sample_secret_polynomial(self, key, device="cuda"):
        """CBD(variance) coefficients -> NTT poly (``parameters.rs:252``)."""
        from ..poly import Poly
        from ..sampling.cbd import sample_vec_cbd

        try:
            coeffs = sample_vec_cbd(key, (self.l,), self.secret_variance, device=device)
        except SamplingError as e:
            raise SamplingError(f"CBD sampling failed: {e.msg}") from e
        return Poly.from_coefficients(coeffs, self.ring, device=device).to_ntt()

    def _sample_error(self, key, batch: tuple, bound: int, device):
        """Uniform values in [-bound, bound] of shape batch + (l,) as an NTT
        poly: the threefry draw of the JAX package for bounds below the
        smallest modulus, its exact host draw above."""
        from ..ops import ntt as ntt_ops
        from ..poly import Poly, Representation
        from ..sampling.uniform import sample_uniform_residues, sample_uniform_residues_host

        sampler = (sample_uniform_residues if bound < min(self.ring.moduli)
                   else sample_uniform_residues_host)
        res = sampler(key, tuple(batch) + (self.l,), bound, self.ring, device)
        return Poly(ntt_ops.ntt_forward(res, self.ring), Representation.Ntt, self.ring)

    def sample_error_1(self, key, batch: tuple[int, ...] = (), device="cuda"):
        """Bounded-uniform error 1, NTT rep (``parameters.rs:264-273``):
        uniform in [-B1, B1], not Gaussian (the reference's quirk)."""
        return self._sample_error(key, batch, self.error_bound_1, device)

    def sample_error_2(self, key, batch: tuple[int, ...] = (), device="cuda"):
        """Bounded-uniform error 2, NTT rep (``parameters.rs:275-284``)."""
        return self._sample_error(key, batch, self.error_bound_2, device)

    # -- gadget / encoding -----------------------------------------------

    def gadget_vector(self) -> list[int]:
        """[1, Δ, Δ², ..., Δ^(l-1)] (``parameters.rs:311-324``)."""
        out = [1]
        for _ in range(self.l - 1):
            out.append(out[-1] * self._delta)
        return out

    def gadget_element(self) -> list[int]:
        """[Δ^(l-1), ..., Δ, 1]: the descending order, which the reference
        has and never calls (``parameters.rs:326-342``)."""
        return list(reversed(self.gadget_vector()))

    def gadget_polynomial(self, device="cuda"):
        """g(X) = Σ Δ^i X^i, NTT rep (``parameters.rs:286-308``)."""
        return self.bigints_to_poly(self.gadget_vector(), device).to_ntt()

    def encode_scalar(self, scalar: int, device="cuda"):
        """scalar * g(X), NTT rep (``parameters.rs:344-367``), the u64
        scalar taken as i64 as the reference's ``as i64`` cast does
        (``encryption.rs:195``)."""
        s = int(scalar)
        if not 0 <= s < 1 << 64:
            raise EncodingError(f"scalar {s} outside the u64 range")
        if s >= 1 << 63:
            s -= 1 << 64
        return self.bigints_to_poly([s * g for g in self.gadget_vector()], device).to_ntt()

    def scalar_to_polynomial(self, scalar: int, device="cuda"):
        """The constant polynomial, NTT rep (``parameters.rs:404-416``)."""
        coeffs = [0] * self.l
        coeffs[0] = int(scalar)
        return self.bigints_to_poly(coeffs, device).to_ntt()

    def bigints_to_poly(self, bigints: list[int], device="cuda"):
        """Integer coefficients of any magnitude -> PowerBasis Poly by RNS
        reduction (``parameters.rs:420-474``)."""
        from ..poly import Poly, Representation

        return Poly.from_residues_np(self.ring.residues_from_int_coeffs(bigints), self.ring,
                                     Representation.PowerBasis, device=device)

    # -- correctness -------------------------------------------------------

    def verify_parameters(self) -> bool:
        """``parameters.rs:477-506``."""
        if self._delta != integer_nth_root(self._q_total, self.l):
            return False
        gv = self.gadget_vector()
        if len(gv) != self.l or gv[0] != 1 or gv[-1] != self._delta_pow:
            return False
        return self.verify_correctness_condition()

    def verify_correctness_condition(self) -> bool:
        """Δ^(l-1) > B2·sqrt(n·l)·(1+sqrt(n)) + 2·B1·k·l + 14·B1·sqrt(n·k·l),
        in f64 exactly like ``parameters.rs:508-551``."""
        n, k, l = float(self.n), float(self.k), float(self.l)
        b1 = _to_f64(self.error_bound_1)
        b2 = _to_f64(self.error_bound_2)
        first = b2 * math.sqrt(n * l) * (1.0 + math.sqrt(n))
        second = 2.0 * b1 * k * l
        third = 14.0 * b1 * math.sqrt(n * k * l)
        return _to_f64(self._delta_pow) > first + second + third

    @staticmethod
    def suggest_error_bounds(n: int, k: int, l: int, moduli, variance: float):
        """Grid search over {50,100,200,500,1000,2000}² (``parameters.rs:554-603``)."""
        temp = PvwParameters(n, k, l, tuple(moduli), variance, 1, 1)
        delta_power = _to_f64(temp._delta_pow)
        n_f, k_f, l_f = float(n), float(k), float(l)
        coeff_b1 = 2.0 * k_f * l_f + 14.0 * math.sqrt(n_f * k_f * l_f)
        coeff_b2 = math.sqrt(n_f * l_f) * (1.0 + math.sqrt(n_f))
        for b1 in (50, 100, 200, 500, 1000, 2000):
            for b2 in (50, 100, 200, 500, 1000, 2000):
                if delta_power > b1 * coeff_b1 + b2 * coeff_b2:
                    return (b1, b2)
        raise InvalidParameters(
            f"Cannot find suitable error bounds for variance {variance} "
            "with the correctness condition"
        )

    def restrict_limbs(self, limb_indices) -> "PvwParameters":
        """A view over a subset of the RNS limbs whose gadget, Δ and
        correctness condition still come from the full q (the JAX package's
        ``restrict_limbs``). Every per-limb quantity of the scheme depends on
        its own limb alone and the randomness is drawn in coefficient space,
        so the limb shards of :mod:`pvw_tpu_torch.parallel` concatenate to
        the full-ring result. ``to_dict`` raises on such a view."""
        idx = tuple(int(i) for i in limb_indices)
        if not idx or any(not 0 <= i < self.ring.num_limbs for i in idx):
            raise InvalidParameters(f"invalid limb indices {idx}")
        sub = PvwParameters.__new__(PvwParameters)
        sub.n, sub.t, sub.k, sub.l = self.n, self.t, self.k, self.l
        sub.secret_variance = self.secret_variance
        sub.error_bound_1 = self.error_bound_1
        sub.error_bound_2 = self.error_bound_2
        sub.ring = get_ring(tuple(self.ring.moduli[i] for i in idx), self.l)
        sub._q_total = self._q_total          # the full q: Δ, gadget, correctness
        sub._delta = self._delta
        sub._delta_pow = self._delta_pow
        sub._build_gadget_tables()            # the full-Δ gadget, sub-limb residues
        return sub

    # -- the 7-field dict form (``parameters.rs:606-664``) ---------------

    def to_dict(self) -> dict:
        if math.prod(self.ring.moduli) != self._q_total:
            raise SerializationError(
                "limb-restricted parameter views cannot be serialized"
            )
        return {
            "n": self.n,
            "k": self.k,
            "l": self.l,
            "moduli": [int(m) for m in self.ring.moduli],
            "secret_variance": self.secret_variance,
            "error_bound_1": str(self.error_bound_1),
            "error_bound_2": str(self.error_bound_2),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PvwParameters":
        return cls(
            d["n"], d["k"], d["l"], tuple(d["moduli"]),
            d["secret_variance"], int(d["error_bound_1"]), int(d["error_bound_2"]),
        )

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, PvwParameters)
                and self.n == other.n
                and self.k == other.k
                and self.l == other.l
                and self.ring.moduli == other.ring.moduli
                and self.secret_variance == other.secret_variance
                and self.error_bound_1 == other.error_bound_1
                and self.error_bound_2 == other.error_bound_2
                and self._q_total == other._q_total)

    def __hash__(self) -> int:
        return hash((self.n, self.k, self.l, self.ring.moduli,
                     self.secret_variance, self.error_bound_1,
                     self.error_bound_2, self._q_total))

    def __repr__(self) -> str:
        return (
            f"PvwParameters(n={self.n}, t={self.t}, k={self.k}, l={self.l}, "
            f"secret_variance={self.secret_variance}, "
            f"error_bounds=({self.error_bound_1}, {self.error_bound_2}), "
            f"moduli={[hex(m) for m in self.ring.moduli]})"
        )

    def to_bytes(self) -> bytes:
        from ..utils.serialization import params_to_bytes
        return params_to_bytes(self)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PvwParameters":
        from ..utils.serialization import params_from_bytes
        return params_from_bytes(data)


class PvwParametersBuilder:
    """Fluent builder (``parameters.rs:44-201``)."""

    def __init__(self) -> None:
        self._n: Optional[int] = None
        self._k: Optional[int] = None
        self._l: Optional[int] = None
        self._moduli: Optional[tuple[int, ...]] = None
        self._secret_variance: Optional[float] = None
        self._error_bound_1: Optional[int] = None
        self._error_bound_2: Optional[int] = None

    def set_parties(self, n: int) -> "PvwParametersBuilder":
        self._n = int(n)
        return self

    def set_dimension(self, k: int) -> "PvwParametersBuilder":
        self._k = int(k)
        return self

    def set_l(self, l: int) -> "PvwParametersBuilder":
        self._l = int(l)
        return self

    def set_moduli(self, moduli) -> "PvwParametersBuilder":
        self._moduli = tuple(int(m) for m in moduli)
        return self

    def set_secret_variance(self, variance: float) -> "PvwParametersBuilder":
        self._secret_variance = float(variance)
        return self

    def set_error_bound_1(self, bound: int) -> "PvwParametersBuilder":
        self._error_bound_1 = int(bound)
        return self

    def set_error_bound_2(self, bound: int) -> "PvwParametersBuilder":
        self._error_bound_2 = int(bound)
        return self

    def set_error_bounds(self, b1: int, b2: int) -> "PvwParametersBuilder":
        self._error_bound_1 = int(b1)
        self._error_bound_2 = int(b2)
        return self

    def set_error_bounds_u32(self, b1: int, b2: int) -> "PvwParametersBuilder":
        return self.set_error_bounds(int(b1), int(b2))

    def build(self) -> PvwParameters:
        if self._n is None:
            raise InvalidParameters("n not set")
        if self._k is None:
            raise InvalidParameters("k not set")
        if self._l is None:
            raise InvalidParameters("l not set")
        if self._moduli is None:
            raise InvalidParameters("moduli not set")
        return PvwParameters(
            self._n, self._k, self._l, self._moduli,
            0.5 if self._secret_variance is None else self._secret_variance,
            100 if self._error_bound_1 is None else self._error_bound_1,
            200 if self._error_bound_2 is None else self._error_bound_2,
        )

    def build_arc(self) -> PvwParameters:
        """``build`` (``parameters.rs:197-200``): Python objects are shared
        by reference already."""
        return self.build()
