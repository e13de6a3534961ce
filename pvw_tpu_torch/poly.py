"""Batches of polynomials over R_q as int64 residue tensors.

The counterpart of ``pvw_tpu.poly``: a :class:`Poly` holds a leading batch
of polynomials, canonical layout ``[*batch, L, l]`` or channel-major
``[L, l, *batch]`` (the layout the fused matmul emits). A channel-major
Poly makes its canonical tensor on first use of :attr:`Poly.res`, so an
encrypt -> decrypt pipeline never pays the transpose.
"""

from __future__ import annotations

from enum import Enum

import numpy as np
import torch

from .errors import ContextError, PolynomialError
from .ops import modmat, ntt as ntt_ops, u64 as u64op
from .params.ring import RingPlan
from .random import fold_in
from .utils.chacha import uniform_residues_from_seeds
from .utils.device import resolve_device


def _random_residues(ring: RingPlan, batch: tuple, key, device) -> torch.Tensor:
    """Uniform residues [*batch, L, l]: limb i from ``fold_in(key, i)``
    with the 128-bit bounded draw (q_i >= 2^30)."""
    from .sampling.uniform import sample_bounded_u64

    shape = tuple(batch) + (ring.degree,)
    limbs = [sample_bounded_u64(fold_in(key, i), shape, q, device)
             for i, q in enumerate(ring.moduli)]
    return torch.stack(limbs, dim=-2)


class Representation(str, Enum):
    """PowerBasis / Ntt (fhe-math's ``rq::Representation``)."""

    PowerBasis = "power"
    Ntt = "ntt"


class Poly:
    """A batch of polynomials in R_q, residues canonical in [0, q_i)."""

    def __init__(self, res: torch.Tensor, rep: Representation, ring: RingPlan) -> None:
        self._res = res
        self._ch = None
        self.rep = rep
        self.ring = ring

    @classmethod
    def from_channel_major(cls, ch: torch.Tensor, rep: Representation,
                           ring: RingPlan) -> "Poly":
        """Wrap channel-major residues ``[L, l, *batch]`` without moving them."""
        p = cls.__new__(cls)
        p._res = None
        p._ch = ch
        p.rep = rep
        p.ring = ring
        return p

    @property
    def res(self) -> torch.Tensor:
        """Canonical residues ``[*batch, L, l]``."""
        if self._res is None:
            nb = self._ch.ndim - 2
            self._res = self._ch.permute(*range(2, 2 + nb), 0, 1).contiguous()
        return self._res

    @property
    def is_channel_major(self) -> bool:
        return self._res is None

    def channel(self) -> torch.Tensor:
        """Residues in channel-major layout ``[L, l, *batch]``."""
        if self._ch is not None:
            return self._ch
        nb = self._res.ndim - 2
        return self._res.permute(nb, nb + 1, *range(nb))

    @property
    def device(self) -> torch.device:
        return (self._res if self._res is not None else self._ch).device

    # -- constructors ---------------------------------------------------

    @classmethod
    def zero(cls, ring: RingPlan, rep: Representation = Representation.Ntt,
             batch: tuple[int, ...] = (), device="cuda") -> "Poly":
        shape = tuple(batch) + (ring.num_limbs, ring.degree)
        return cls(torch.zeros(shape, dtype=torch.int64,
                               device=resolve_device(device)), rep, ring)

    @classmethod
    def random(cls, ring: RingPlan, rep: Representation, key,
               batch: tuple[int, ...] = (), device="cuda") -> "Poly":
        """Uniform element(s) of R_q from a threefry key (``Poly::random``),
        bit-identical to the JAX package for the same key."""
        return cls(_random_residues(ring, tuple(batch), key, resolve_device(device)),
                   rep, ring)

    @classmethod
    def random_from_seed(cls, ring: RingPlan, rep: Representation, seed: bytes,
                         batch: tuple[int, ...] = (), device="cuda") -> "Poly":
        """Uniform element(s) from a 32-byte seed (``Poly::random_from_seed``,
        ``crs.rs:60``): ChaCha8 and Lemire rejection on the host; every
        element of a batch takes the same seed, as in the JAX package."""
        batch = tuple(batch)
        n = int(np.prod(batch)) if batch else 1
        seeds = np.tile(np.frombuffer(seed, np.uint8), (n, 1))
        vals = uniform_residues_from_seeds(seeds, ring.moduli, ring.degree)
        return cls(u64op.u64_tensor(vals.reshape(batch + (ring.num_limbs, ring.degree)),
                                    resolve_device(device)), rep, ring)

    @classmethod
    def from_coefficients(cls, coeffs, ring: RingPlan, device="cuda") -> "Poly":
        """Small signed coefficients [..., l] -> PowerBasis poly."""
        c = torch.as_tensor(coeffs).to(resolve_device(device))
        if c.shape[-1] != ring.degree:
            raise PolynomialError(f"expected last dim {ring.degree}, got {c.shape[-1]}")
        return cls(modmat.from_signed_coeffs(c, ring), Representation.PowerBasis, ring)

    @classmethod
    def from_residues_np(cls, residues: np.ndarray, ring: RingPlan,
                         rep: Representation, device="cuda") -> "Poly":
        """Host uint64 residues [..., L, l] -> Poly."""
        residues = np.asarray(residues, np.uint64)
        qs = ring.q.reshape((1,) * (residues.ndim - 2) + (ring.num_limbs, 1))
        if np.any(residues >= qs):
            raise PolynomialError("residue out of range for modulus")
        return cls(u64op.u64_tensor(residues, resolve_device(device)), rep, ring)

    # -- accessors ------------------------------------------------------

    @property
    def batch_shape(self) -> tuple[int, ...]:
        if self._res is None:
            return tuple(self._ch.shape[2:])
        return tuple(self._res.shape[:-2])

    def representation(self) -> Representation:
        """``poly.representation()`` (``crs.rs:124``)."""
        return self.rep

    def residues_np(self) -> np.ndarray:
        """Host uint64 residues [..., L, l] (``pvw_tpu.Poly.residues_np``)."""
        return u64op.u64_numpy(self.res)

    def coefficients_int(self) -> np.ndarray:
        """CRT lift to canonical integer coefficients in [0, q), an object
        array [..., l] of Python ints (``Vec<BigUint>::from``); PowerBasis
        only."""
        if self.rep != Representation.PowerBasis:
            raise PolynomialError("coefficients_int requires PowerBasis")
        res = self.residues_np()
        flat = res.reshape((-1,) + res.shape[-2:])
        out = np.empty((flat.shape[0], self.ring.degree), object)
        for e in range(flat.shape[0]):
            out[e] = self.ring.lift_to_ints(flat[e])
        return out.reshape(res.shape[:-2] + (self.ring.degree,))

    # -- representation changes ----------------------------------------

    def change_representation(self, rep: Representation) -> "Poly":
        rep = Representation(rep)
        if rep == self.rep:
            return self
        if rep == Representation.Ntt:
            return Poly(ntt_ops.ntt_forward(self.res, self.ring), rep, self.ring)
        return Poly(ntt_ops.ntt_inverse(self.res, self.ring), rep, self.ring)

    def to_ntt(self) -> "Poly":
        return self.change_representation(Representation.Ntt)

    def to_power_basis(self) -> "Poly":
        return self.change_representation(Representation.PowerBasis)

    # -- ring operators -------------------------------------------------

    def _check_compat(self, other: "Poly", op: str) -> None:
        if self.ring != other.ring:
            raise ContextError(f"{op}: ring/context mismatch")
        if self.rep != other.rep:
            raise PolynomialError(f"{op}: representation mismatch")

    def __add__(self, other: "Poly") -> "Poly":
        self._check_compat(other, "add")
        return Poly(modmat.poly_add(self.res, other.res, self.ring), self.rep, self.ring)

    def __sub__(self, other: "Poly") -> "Poly":
        self._check_compat(other, "sub")
        return Poly(modmat.poly_sub(self.res, other.res, self.ring), self.rep, self.ring)

    def __neg__(self) -> "Poly":
        return Poly(modmat.poly_neg(self.res, self.ring), self.rep, self.ring)

    def __mul__(self, other: "Poly") -> "Poly":
        """Ring product, pointwise in the NTT domain (both operands Ntt, as
        fhe-math's operator requires)."""
        self._check_compat(other, "mul")
        if self.rep != Representation.Ntt:
            raise PolynomialError("mul requires Ntt representation")
        return Poly(modmat.poly_pointwise_mul(self.res, other.res, self.ring), self.rep,
                    self.ring)

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Poly):
            return NotImplemented
        return (self.ring == other.ring and self.rep == other.rep
                and bool(torch.equal(self.res, other.res)))

    def __getitem__(self, idx) -> "Poly":
        """Index into the leading batch dims."""
        if self._res is None and isinstance(idx, (int, np.integer)):
            return Poly.from_channel_major(self._ch[:, :, idx], self.rep, self.ring)
        return Poly(self.res[idx], self.rep, self.ring)

    def __repr__(self) -> str:
        return (f"Poly(batch={self.batch_shape}, rep={self.rep.value}, "
                f"L={self.ring.num_limbs}, l={self.ring.degree}, device={self.device})")

    def to_bytes(self) -> bytes:
        """The PVWT byte form (:mod:`pvw_tpu_torch.utils.serialization`)."""
        from .utils.serialization import poly_to_bytes
        return poly_to_bytes(self)

    @classmethod
    def from_bytes(cls, data: bytes, ring=None, device="cuda") -> "Poly":
        from .utils.serialization import poly_from_bytes
        return poly_from_bytes(data, ring, device=device)


def stack(polys: list[Poly], axis: int = 0) -> Poly:
    """Stack same-ring, same-rep polys along a new leading batch axis."""
    if not polys:
        raise PolynomialError("cannot stack empty list")
    p0 = polys[0]
    for p in polys[1:]:
        p0._check_compat(p, "stack")
    return Poly(torch.stack([p.res for p in polys], dim=axis), p0.rep, p0.ring)
