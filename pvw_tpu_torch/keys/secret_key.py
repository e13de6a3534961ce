"""PVW secret keys: the k x l CBD coefficient matrix.

The counterpart of ``pvw_tpu.keys.secret_key`` (the reference's
``secret_key.rs``). Coefficients live in a host numpy int32 array so they
can be zeroized in place; the NTT polynomials are made per device on
demand and cached.
"""

from __future__ import annotations

import numpy as np

from ..errors import InvalidParameters, SamplingError
from ..params.parameters import PvwParameters
from ..poly import Poly
from ..sampling.cbd import sample_vec_cbd
from ..utils.device import resolve_device


class SecretKey:
    """``SecretKey`` (``secret_key.rs:14-18``)."""

    def __init__(self, params: PvwParameters, secret_coeffs) -> None:
        self.params = params
        self.secret_coeffs = np.array(secret_coeffs, np.int32, copy=True)
        self._poly_cache: dict = {}

    @classmethod
    def random(cls, params: PvwParameters, key, device="cuda") -> "SecretKey":
        """CBD(secret_variance) sampling of the k x l matrix
        (``secret_key.rs:45-63``), deterministic in ``key``."""
        try:
            coeffs = sample_vec_cbd(key, (params.k, params.l),
                                    params.secret_variance, device=device)
        except SamplingError as e:
            raise SamplingError(f"CBD sampling failed: {e.msg}") from e
        return cls(params, coeffs.cpu().numpy())

    @classmethod
    def from_coefficients(cls, params: PvwParameters, coefficients) -> "SecretKey":
        """``secret_key.rs:258-269``: validates structure."""
        sk = cls(params, np.asarray(coefficients, np.int32))
        sk.validate()
        return sk

    def to_polynomials(self, device="cuda") -> Poly:
        """All k polynomials as one NTT Poly batch (k,) on ``device``,
        cached per device (``secret_key.rs:72-85``)."""
        dev = resolve_device(device)
        if dev not in self._poly_cache:
            self._poly_cache[dev] = Poly.from_coefficients(
                self.secret_coeffs, self.params.ring, device=dev).to_ntt()
        return self._poly_cache[dev]

    def coefficients(self) -> np.ndarray:
        """k x l int32 view (``secret_key.rs:122-124``)."""
        return self.secret_coeffs

    def __len__(self) -> int:
        return len(self.secret_coeffs)

    def validate(self) -> None:
        """``secret_key.rs:194-216``."""
        if len(self.secret_coeffs) != self.params.k:
            raise InvalidParameters(
                f"Secret key has {len(self.secret_coeffs)} polynomials "
                f"but k={self.params.k}"
            )
        if self.secret_coeffs.ndim != 2 or self.secret_coeffs.shape[1] != self.params.l:
            raise InvalidParameters(
                f"Secret key polynomial has {self.secret_coeffs.shape[-1]} "
                f"coefficients but l={self.params.l}"
            )

    def zeroize(self) -> None:
        """Zero the host coefficients in place and drop the device polys
        (device memory cannot be scrubbed)."""
        self.secret_coeffs[...] = 0
        self.secret_coeffs = np.zeros((0, self.params.l), np.int32)
        self._poly_cache = {}

    def __repr__(self) -> str:
        return f"SecretKey(k={self.params.k}, l={self.params.l})"
