"""Named parameter presets, the same set as ``pvw_tpu.params.presets``.

``toy``/``vector_k256``/``pvss_8192`` use the reference's example chain
(``examples/pvw.rs:32``); ``secure_128_reference`` is the reference's
128-bit example (``examples/pvw_valid_dec.py:40-48``, from the upstream
``examples/pvw_valid_dec.rs:40-52``); the 61-bit chains
come from :func:`generate_ntt_primes`. Each preset returns a fresh
:class:`PvwParameters`.
"""

from __future__ import annotations

from ..errors import InvalidParameters
from ..utils.intmath import generate_ntt_primes
from .parameters import PvwParameters, PvwParametersBuilder

MODULI_TOY = (0xFFFFC4001, 0x1FFFFE0001)                       # ~77-bit q
MODULI_TEST3 = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)        # ~113-bit q
MODULI_55BIT4 = (0x800000022A0001, 0x800000021A0001,
                 0x80000002120001, 0x80000001F60001)            # ~221-bit q


def _build(n, k, l, moduli, var, b1=None, b2=None):
    builder = (PvwParametersBuilder().set_parties(n).set_dimension(k)
               .set_l(l).set_moduli(moduli).set_secret_variance(var))
    if b1 is None:
        b1, b2 = PvwParameters.suggest_error_bounds(n, k, l, moduli, var)
    return builder.set_error_bounds_u32(b1, b2).build()


def toy(n: int = 7) -> PvwParameters:
    """The examples/pvw.rs demo configuration: k=32, l=8, 2-limb chain."""
    return _build(n, 32, 8, MODULI_TOY, 0.5)


def vector_k256(n: int = 64) -> PvwParameters:
    return _build(n, 256, 8, MODULI_TOY, 0.5)


def broadcast_128bit(n: int = 64) -> PvwParameters:
    return _build(n, 256, 8, generate_ntt_primes(61, 17, 8), 0.5)


def shares_n1024(n: int = 1024) -> PvwParameters:
    return _build(n, 256, 8, MODULI_55BIT4, 0.5)


def threshold_256bit(n: int = 1024) -> PvwParameters:
    return _build(n, 512, 16, generate_ntt_primes(61, 17, 16), 0.5)


def pvss_8192(n: int = 8192) -> PvwParameters:
    return _build(n, 256, 8, MODULI_TOY, 0.5)


def secure_128_reference(n: int = 5) -> PvwParameters:
    return _build(n, 1024, 8, MODULI_55BIT4, 10.0, 1, 1172385)


PRESETS = {
    "toy": toy,
    "vector_k256": vector_k256,
    "broadcast_128bit": broadcast_128bit,
    "shares_n1024": shares_n1024,
    "threshold_256bit": threshold_256bit,
    "pvss_8192": pvss_8192,
    "secure_128_reference": secure_128_reference,
}


def get_preset(name: str, **kwargs) -> PvwParameters:
    """Look up a preset by name; kwargs override the party count."""
    if name not in PRESETS:
        raise InvalidParameters(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name](**kwargs)
