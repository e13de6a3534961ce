"""Common Reference String: the k x k uniform matrix over R_q.

The counterpart of ``pvw_tpu.params.crs`` (the reference's ``crs.rs``):
one :class:`~pvw_tpu_torch.poly.Poly` of batch shape (k, k) in NTT
representation, on the device it was made for. A change of an element
installs a new tensor, so that the encryption operands cached on the
matrix's identity (``GlobalPublicKey._cached_operands``) are remade.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from ..errors import CrsError, DimensionMismatch, IndexOutOfBounds, InvalidParameters
from ..ops import modmat
from ..poly import Poly, Representation
from ..utils.chacha import ChaCha8Rng, uniform_residues_from_seeds
from ..utils.siphash import tag_seed
from .parameters import PvwParameters


class PvwCrs:
    """k x k CRS matrix A in NTT representation (``crs.rs:12-17``)."""

    def __init__(self, matrix: Poly, params: PvwParameters) -> None:
        self.matrix = matrix
        self.params = params

    @property
    def device(self):
        return self.matrix.device

    @classmethod
    def new(cls, params: PvwParameters, key, device="cuda") -> "PvwCrs":
        """Random CRS from a threefry key (``crs.rs:24-39``)."""
        matrix = Poly.random(params.ring, Representation.Ntt, key,
                             batch=(params.k, params.k), device=device)
        return cls(matrix, params)

    @classmethod
    def new_deterministic(cls, params: PvwParameters, seed: bytes,
                          device="cuda") -> "PvwCrs":
        """CRS from a 32-byte master seed (``crs.rs:45-67``): a ChaCha8
        master stream gives one 32-byte seed per element (row-major), each
        expanded to uniform residues on the host."""
        if len(seed) != 32:
            raise CrsError(f"seed must be 32 bytes, got {len(seed)}")
        k = params.k
        master = ChaCha8Rng(seed)
        seeds = np.frombuffer(master.next_bytes(32 * k * k), np.uint8).reshape(k * k, 32)
        vals = uniform_residues_from_seeds(
            seeds, params.ring.moduli, params.ring.degree
        ).reshape(k, k, params.ring.num_limbs, params.ring.degree)
        return cls(Poly.from_residues_np(vals, params.ring, Representation.Ntt,
                                         device=device), params)

    @classmethod
    def new_from_tag(cls, params: PvwParameters, tag: str, device="cuda") -> "PvwCrs":
        """CRS from a string tag (``crs.rs:74-90``): seed =
        SipHash-1-3(tag + "CRS") cycled to 32 bytes."""
        return cls.new_deterministic(params, tag_seed(tag), device=device)

    def get(self, i: int, j: int) -> Optional[Poly]:
        """Element (i, j) (``crs.rs:93-95``)."""
        if not (0 <= i < self.params.k and 0 <= j < self.params.k):
            return None
        return self.matrix[i, j]

    def set_element(self, i: int, j: int, poly: Poly) -> None:
        """Replace element (i, j) (``get_mut``, ``crs.rs:98-100``), into a
        new matrix tensor."""
        if not (0 <= i < self.params.k and 0 <= j < self.params.k):
            raise InvalidParameters(f"index ({i}, {j}) out of bounds")
        if poly.ring != self.params.ring:
            raise InvalidParameters("CRS polynomial context mismatch")
        res = self.matrix.res.clone()
        res[i, j] = poly.to_ntt().res.to(res.device)
        self.matrix = Poly(res, Representation.Ntt, self.params.ring)

    def dimensions(self) -> tuple[int, int]:
        return (self.params.k, self.params.k)

    def __len__(self) -> int:
        return self.params.k * self.params.k

    def is_empty(self) -> bool:
        return self.params.k == 0

    def __iter__(self) -> Iterator[Poly]:
        for i in range(self.params.k):
            for j in range(self.params.k):
                yield self.matrix[i, j]

    def validate(self) -> None:
        """``crs.rs:108-132``."""
        shape = self.matrix.batch_shape
        if shape != (self.params.k, self.params.k):
            raise InvalidParameters(
                f"CRS matrix dimensions {shape[0]}×{shape[1]} don't match "
                f"parameter k={self.params.k}"
            )
        if self.matrix.ring != self.params.ring:
            raise InvalidParameters("CRS polynomial context mismatch")
        if self.matrix.rep != Representation.Ntt:
            raise InvalidParameters("CRS polynomial not in NTT representation")

    # -- products -------------------------------------------------------

    def _check_matrix_extent(self) -> None:
        """A stored matrix smaller than k x k is the reference's ``get(i, j)``
        returning ``None`` mid-multiply (``crs.rs:158-161, 192-195``)."""
        for extent in self.matrix.batch_shape[:2]:
            if extent < self.params.k:
                raise IndexOutOfBounds(extent, self.params.k)

    def multiply_by_secret_key(self, secret_key) -> Poly:
        """sᵀA: result[i] = Σ_j s[j] · A[j][i] (``crs.rs:138-171``), one
        [1, k] x [k, k] product over every (limb, slot) channel."""
        sk = secret_key.to_polynomials(self.device)
        if sk.batch_shape[0] != self.params.k:
            raise InvalidParameters(
                f"Secret key length {sk.batch_shape[0]} doesn't match "
                f"CRS dimension k={self.params.k}"
            )
        self._check_matrix_extent()
        out = modmat.poly_matmul(sk.res[None], self.matrix.res, self.params.ring)
        return Poly(out[0], Representation.Ntt, self.params.ring)

    def multiply_by_randomness(self, randomness: Poly) -> Poly:
        """A·r: result[i] = Σ_j A[i][j] · r[j] (``crs.rs:177-205``);
        ``randomness`` of batch shape (k,) or (k, d) for d encryptions."""
        shape = randomness.batch_shape
        if shape[0] != self.params.k:
            raise DimensionMismatch(self.params.k, shape[0])
        self._check_matrix_extent()
        r = randomness.res.to(self.device)
        out = modmat.poly_matmul(self.matrix.res, r[:, None] if len(shape) == 1 else r,
                                 self.params.ring)
        return Poly(out[:, 0] if len(shape) == 1 else out, Representation.Ntt,
                    self.params.ring)

    def __repr__(self) -> str:
        return f"PvwCrs(k={self.params.k}, ring={self.params.ring}, device={self.device})"

    def to_bytes(self) -> bytes:
        from ..utils.serialization import crs_to_bytes
        return crs_to_bytes(self)

    @classmethod
    def from_bytes(cls, data: bytes, device="cuda") -> "PvwCrs":
        from ..utils.serialization import crs_from_bytes
        return crs_from_bytes(data, device=device)
