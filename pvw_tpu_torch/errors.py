"""Error taxonomy of the PyTorch port.

A copy of ``pvw_tpu.errors``: the reference's 19-variant ``thiserror`` enum
(``src/errors.rs:13-70`` of pvw-rs) as a Python exception hierarchy with the
same class names and display strings, so code ported from ``pvw_tpu``
catches the same exceptions. Kept as a copy because the port imports
nothing from ``pvw_tpu``.
"""

from __future__ import annotations


class PvwError(Exception):
    """Base class for every pvw-tpu error (``errors.rs:13``)."""


class InvalidParameters(PvwError):
    """``errors.rs:14-15`` — "Invalid parameters: {0}"."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Invalid parameters: {msg}")
        self.msg = msg


class SamplingError(PvwError):
    """``errors.rs:17-18``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Sampling error: {msg}")
        self.msg = msg


class EncryptionError(PvwError):
    """``errors.rs:20-21``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Encryption error: {msg}")
        self.msg = msg


class DecryptionError(PvwError):
    """``errors.rs:23-24``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Decryption error: {msg}")
        self.msg = msg


class KeyGenerationError(PvwError):
    """``errors.rs:26-27``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Key generation error: {msg}")
        self.msg = msg


class CrsError(PvwError):
    """``errors.rs:29-30``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"CRS error: {msg}")
        self.msg = msg


class SerializationError(PvwError):
    """``errors.rs:32-33``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Serialization error: {msg}")
        self.msg = msg


class DeserializationError(PvwError):
    """``errors.rs:35-36``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Deserialization error: {msg}")
        self.msg = msg


class EncodingError(PvwError):
    """``errors.rs:38-39``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Encoding error: {msg}")
        self.msg = msg


class DecodingError(PvwError):
    """``errors.rs:41-42``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Decoding error: {msg}")
        self.msg = msg


class ValidationError(PvwError):
    """``errors.rs:44-45``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Validation error: {msg}")
        self.msg = msg


class ContextError(PvwError):
    """``errors.rs:47-48``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Context error: {msg}")
        self.msg = msg


class PolynomialError(PvwError):
    """``errors.rs:50-51``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Polynomial error: {msg}")
        self.msg = msg


class MatrixError(PvwError):
    """``errors.rs:53-54``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Matrix error: {msg}")
        self.msg = msg


class DimensionMismatch(PvwError):
    """``errors.rs:56-57`` — structured variant with expected/actual fields."""

    def __init__(self, expected: int, actual: int) -> None:
        super().__init__(f"Dimension mismatch: expected {expected}, got {actual}")
        self.expected = expected
        self.actual = actual


class IndexOutOfBounds(PvwError):
    """``errors.rs:59-60`` — structured variant with index/bound fields."""

    def __init__(self, index: int, bound: int) -> None:
        super().__init__(f"Index out of bounds: {index} >= {bound}")
        self.index = index
        self.bound = bound


class InsufficientData(PvwError):
    """``errors.rs:62-63`` — structured variant with expected/actual byte counts."""

    def __init__(self, expected: int, actual: int) -> None:
        super().__init__(f"Insufficient data: expected {expected} bytes, got {actual}")
        self.expected = expected
        self.actual = actual


class InvalidFormat(PvwError):
    """``errors.rs:65-66``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Invalid format: {msg}")
        self.msg = msg


class InternalError(PvwError):
    """``errors.rs:68-69``."""

    def __init__(self, msg: str) -> None:
        super().__init__(f"Internal error: {msg}")
        self.msg = msg


# Additions over the reference (documented divergences) ----------------------


class InsufficientValidCiphertexts(PvwError):
    """Raised by the threshold-decryption helpers when fewer validated dealer
    ciphertexts are available than the threshold requires.

    The reference implements this abort only in example code
    (``examples/pvw_valid_dec.rs:160-195``); pvw-tpu promotes it to a
    first-class library error.
    """

    def __init__(self, valid: int, threshold: int) -> None:
        super().__init__(
            f"Insufficient valid ciphertexts: {valid} < threshold {threshold}"
        )
        self.valid = valid
        self.threshold = threshold


class PvwResult:
    """``PvwResult<T> = Result<T, PvwError>`` (errors.rs:73), as an
    annotation helper: Python signals the error arm by raising
    :class:`PvwError`, so ``PvwResult[T]`` simply resolves to ``T`` —
    ``def decrypt(...) -> PvwResult[int]`` reads like the reference
    signature and type-checks as ``int``. Not instantiable."""

    def __class_getitem__(cls, item):
        return item

    def __init__(self) -> None:
        raise TypeError(
            "PvwResult is an annotation alias; functions raise PvwError "
            "instead of returning a Result"
        )
