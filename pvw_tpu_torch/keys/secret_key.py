"""PVW secret keys: the k x l CBD coefficient matrix.

The counterpart of ``pvw_tpu.keys.secret_key`` (the reference's
``secret_key.rs``). Coefficients live in a host numpy int32 array so they
can be zeroized in place; the NTT polynomials are made per device on
demand and cached, and so are their residues on the host (the operand of
the host decryption). A mutable accessor drops both caches.
"""

from __future__ import annotations

from typing import Optional

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
        self._host_ntt_cache: Optional[np.ndarray] = None

    def _drop_caches(self) -> None:
        self._poly_cache = {}
        self._host_ntt_cache = None

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

    def host_ntt_residues(self) -> np.ndarray:
        """uint64 [k, L, l] NTT residues on the host, cached: the secret-key
        operand of the host decryption
        (:func:`~pvw_tpu_torch.utils.native_decode.decrypt_decode_pairs_native`)."""
        if self._host_ntt_cache is None:
            made = list(self._poly_cache.values())   # any device's polys will do
            polys = made[0] if made else self.to_polynomials("cpu")
            self._host_ntt_cache = np.ascontiguousarray(polys.residues_np())
        return self._host_ntt_cache

    def get_polynomial(self, index: int, device="cuda") -> Poly:
        """One NTT polynomial (``secret_key.rs:98-112``)."""
        if index >= len(self.secret_coeffs):
            raise InvalidParameters(
                f"Index {index} out of bounds for {len(self.secret_coeffs)} polynomials"
            )
        return self.to_polynomials(device)[index]

    def as_poly_vector(self, device="cuda") -> Poly:
        """Legacy alias (``secret_key.rs:173-175``)."""
        return self.to_polynomials(device)

    # -- coefficient access ----------------------------------------------

    def coefficients(self) -> np.ndarray:
        """k x l int32 view (``secret_key.rs:122-124``)."""
        return self.secret_coeffs

    def coefficients_mut(self) -> np.ndarray:
        """Mutable access; drops the polynomial caches
        (``secret_key.rs:133-135``)."""
        self._drop_caches()
        return self.secret_coeffs

    def get_coefficients(self, index: int) -> Optional[np.ndarray]:
        if 0 <= index < len(self.secret_coeffs):
            return self.secret_coeffs[index]
        return None

    def get_coefficients_mut(self, index: int) -> Optional[np.ndarray]:
        if 0 <= index < len(self.secret_coeffs):
            self._drop_caches()
            return self.secret_coeffs[index]
        return None

    def to_coefficient_matrix(self) -> np.ndarray:
        """A copy (``secret_key.rs:160-162``)."""
        return self.secret_coeffs.copy()

    def as_matrix(self) -> np.ndarray:
        return self.to_coefficient_matrix()

    def as_matrix_mut(self) -> np.ndarray:
        return self.to_coefficient_matrix()

    # -- structure --------------------------------------------------------

    def __len__(self) -> int:
        return len(self.secret_coeffs)

    def is_empty(self) -> bool:
        return len(self.secret_coeffs) == 0

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

    def validate_coefficient_bounds(self) -> None:
        """``secret_key.rs:225-245``, with the reference's quirk: the bound
        is ``2 * (variance as i64)``, so variance 0.5 gives bound 0 and
        any nonzero coefficient fails."""
        max_bound = 2 * int(self.params.secret_variance)
        bad = np.abs(self.secret_coeffs) > max_bound
        if np.any(bad):
            pi, ci = map(int, np.argwhere(bad)[0])
            c = int(self.secret_coeffs[pi, ci])
            raise InvalidParameters(
                f"Coefficient at polynomial {pi} index {ci} is {c} but should "
                f"be in [-{max_bound}, {max_bound}] for variance "
                f"{self.params.secret_variance}"
            )

    def coefficient_stats(self) -> tuple[int, int, float]:
        """(min, max, mean) (``secret_key.rs:278-291``)."""
        if self.secret_coeffs.size == 0:
            return (0, 0, 0.0)
        return (int(self.secret_coeffs.min()), int(self.secret_coeffs.max()),
                float(self.secret_coeffs.mean()))

    def zeroize(self) -> None:
        """Zero the host coefficients in place and drop the device polys
        (device memory cannot be scrubbed)."""
        self.secret_coeffs[...] = 0
        self.secret_coeffs = np.zeros((0, self.params.l), np.int32)
        self._drop_caches()

    def __repr__(self) -> str:
        return f"SecretKey(k={self.params.k}, l={self.params.l})"

    def to_bytes(self) -> bytes:
        from ..utils.serialization import secret_key_to_bytes
        return secret_key_to_bytes(self)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        from ..utils.serialization import secret_key_from_bytes
        return secret_key_from_bytes(data)
