"""Common Reference String: the k x k uniform matrix over R_q.

The counterpart of ``pvw_tpu.params.crs`` (the reference's ``crs.rs``):
one :class:`~pvw_tpu_torch.poly.Poly` of batch shape (k, k) in NTT
representation, on the device it was made for.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..errors import CrsError, InvalidParameters
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

    def dimensions(self) -> tuple[int, int]:
        return (self.params.k, self.params.k)

    def __len__(self) -> int:
        return self.params.k * self.params.k

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

    def __repr__(self) -> str:
        return f"PvwCrs(k={self.params.k}, ring={self.params.ring}, device={self.device})"
