"""Serialization, encoding and validation interfaces.

The counterpart of ``pvw_tpu.traits`` (the reference's ``traits/mod.rs``).
The reference declares these traits and serializes with serde instead
(its ``Encode`` trait has no implementation); they are kept for API
parity, and ``Serialize`` is what the PVWT codecs of
:mod:`pvw_tpu_torch.utils.serialization` provide.
"""

from __future__ import annotations

import abc

from .errors import PvwError


class Serialize(abc.ABC):
    """``traits/mod.rs:9-17``."""

    @abc.abstractmethod
    def to_bytes(self) -> bytes: ...

    @classmethod
    @abc.abstractmethod
    def from_bytes(cls, data: bytes) -> "Serialize": ...


class Encode(abc.ABC):
    """``traits/mod.rs:20-28``: declared and never implemented in the
    reference; kept for parity."""

    @abc.abstractmethod
    def encode(self) -> bytes: ...

    @classmethod
    @abc.abstractmethod
    def decode(cls, data: bytes) -> "Encode": ...


class Validate(abc.ABC):
    """``traits/mod.rs:31-39``."""

    @abc.abstractmethod
    def validate(self) -> None: ...

    def is_valid(self) -> bool:
        try:
            self.validate()
            return True
        except PvwError:
            return False
