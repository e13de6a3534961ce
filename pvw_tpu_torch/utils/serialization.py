"""Stable byte serialization of every PVW type: the PVWT container.

The counterpart of ``pvw_tpu.utils.serialization``, byte for byte: each
package loads the other's bytes. The container is

    b"PVWT" | u8 version | u32 header_len | header JSON (utf-8, sorted
    keys, compact separators) | payload (raw little-endian arrays)

The header carries the type tag, the parameters' 7-field dict (the
context is rebuilt on load, ``parameters.rs:606-664``), and the payload's
section table (shapes and numpy dtype strings). Residues travel as uint64
(``<u8``): the port's int64 residue tensors are written as their uint64
values. Secret coefficients travel as int64 (``<i8``). Loading builds the
tensors on ``device`` (default ``"cuda"``; ``"cpu"`` for the host).
Limb-restricted parameter views refuse serialization (``to_dict``).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..errors import DeserializationError, InsufficientData, InvalidFormat, SerializationError

MAGIC = b"PVWT"
VERSION = 1


def _pack(type_tag: str, header_extra: dict, sections: list[np.ndarray]) -> bytes:
    header = dict(header_extra)
    header["type"] = type_tag
    header["sections"] = {"shapes": [list(a.shape) for a in sections],
                          "dtypes": [a.dtype.str for a in sections]}
    hjson = json.dumps(header, sort_keys=True, separators=(",", ":")).encode()
    parts = [MAGIC, bytes([VERSION]), len(hjson).to_bytes(4, "little"), hjson]
    parts += [np.ascontiguousarray(a, a.dtype.newbyteorder("<")).tobytes() for a in sections]
    return b"".join(parts)


def _header(data: bytes) -> dict:
    if len(data) < 9 or data[:4] != MAGIC:
        raise InvalidFormat("not a PVWT blob")
    if data[4] != VERSION:
        raise InvalidFormat(f"unsupported version {data[4]}")
    hlen = int.from_bytes(data[5:9], "little")
    if len(data) < 9 + hlen:
        raise InsufficientData(9 + hlen, len(data))
    try:
        return json.loads(data[9:9 + hlen].decode())
    except (UnicodeDecodeError, ValueError) as e:
        raise DeserializationError(f"bad header: {e}") from e


def _unpack(data: bytes, expect_type: str) -> tuple[dict, list[np.ndarray]]:
    header = _header(data)
    if header.get("type") != expect_type:
        raise DeserializationError(
            f"expected type {expect_type!r}, got {header.get('type')!r}"
        )
    off = 9 + int.from_bytes(data[5:9], "little")
    sections = []
    for shape, dt in zip(header["sections"]["shapes"], header["sections"]["dtypes"]):
        dtype = np.dtype(dt)
        nb = int(np.prod(shape)) * dtype.itemsize if shape else dtype.itemsize
        if len(data) < off + nb:
            raise InsufficientData(off + nb, len(data))
        sections.append(np.frombuffer(data, dtype=dtype, count=nb // dtype.itemsize,
                                      offset=off).reshape(shape))
        off += nb
    return header, sections


def _params(header: dict):
    from ..params.parameters import PvwParameters

    return PvwParameters.from_dict(header["params"])


def _ntt_poly(res: np.ndarray, params, device):
    from ..poly import Poly, Representation

    return Poly.from_residues_np(res, params.ring, Representation.Ntt, device=device)


# --------------------------------------------------------------------------
# per-type codecs
# --------------------------------------------------------------------------

def params_to_bytes(params) -> bytes:
    return _pack("params", {"params": params.to_dict()}, [])


def params_from_bytes(data: bytes):
    header, _ = _unpack(data, "params")
    return _params(header)


def poly_to_bytes(poly) -> bytes:
    return _pack("poly", {"rep": poly.rep.value,
                          "moduli": [int(m) for m in poly.ring.moduli],
                          "degree": poly.ring.degree},
                 [poly.residues_np()])


def poly_from_bytes(data: bytes, ring=None, device="cuda"):
    from ..params.ring import get_ring
    from ..poly import Poly, Representation

    header, (res,) = _unpack(data, "poly")
    r = ring or get_ring(tuple(header["moduli"]), header["degree"])
    if tuple(int(m) for m in header["moduli"]) != r.moduli:
        raise DeserializationError("modulus chain mismatch")
    return Poly.from_residues_np(res, r, Representation(header["rep"]), device=device)


def secret_key_to_bytes(sk) -> bytes:
    return _pack("secret_key", {"params": sk.params.to_dict()},
                 [sk.secret_coeffs.astype("<i8")])


def secret_key_from_bytes(data: bytes):
    from ..keys.secret_key import SecretKey

    header, (coeffs,) = _unpack(data, "secret_key")
    return SecretKey.from_coefficients(_params(header), coeffs.astype(np.int32))


def crs_to_bytes(crs) -> bytes:
    return _pack("crs", {"params": crs.params.to_dict()}, [crs.matrix.residues_np()])


def crs_from_bytes(data: bytes, device="cuda"):
    from ..params.crs import PvwCrs

    header, (res,) = _unpack(data, "crs")
    params = _params(header)
    return PvwCrs(_ntt_poly(res, params, device), params)


def public_key_to_bytes(pk) -> bytes:
    return _pack("public_key", {"params": pk.params.to_dict()},
                 [pk.key_polynomials.residues_np()])


def public_key_from_bytes(data: bytes, device="cuda"):
    from ..keys.public_key import PublicKey

    header, (res,) = _unpack(data, "public_key")
    params = _params(header)
    return PublicKey(_ntt_poly(res, params, device), params)


def global_public_key_to_bytes(gpk) -> bytes:
    sections = [gpk.matrix.residues_np(), gpk.crs.matrix.residues_np()]
    sections += [e.residues_np() for e in gpk.error_polynomials if e is not None]
    return _pack("global_public_key",
                 {"params": gpk.params.to_dict(), "num_keys": gpk.num_keys,
                  "errors_present": [e is not None for e in gpk.error_polynomials]},
                 sections)


def global_public_key_from_bytes(data: bytes, device="cuda"):
    from ..keys.public_key import GlobalPublicKey
    from ..params.crs import PvwCrs

    header, sections = _unpack(data, "global_public_key")
    params = _params(header)
    gpk = GlobalPublicKey(PvwCrs(_ntt_poly(sections[1], params, device), params))
    gpk.matrix = _ntt_poly(sections[0], params, device)
    gpk.num_keys = int(header["num_keys"])
    rest = iter(sections[2:])
    errors: list[Optional[object]] = []
    for present in header["errors_present"]:
        errors.append(_ntt_poly(next(rest), params, device) if present else None)
    gpk.error_polynomials = errors
    return gpk


def ciphertext_to_bytes(ct) -> bytes:
    return _pack("ciphertext", {"params": ct.params.to_dict()},
                 [ct.c1.residues_np(), ct.c2.residues_np()])


def ciphertext_from_bytes(data: bytes, device="cuda"):
    from ..crypto.encryption import PvwCiphertext

    header, (c1, c2) = _unpack(data, "ciphertext")
    params = _params(header)
    return PvwCiphertext(_ntt_poly(c1, params, device), _ntt_poly(c2, params, device),
                         params)


# --------------------------------------------------------------------------
# generic dispatch
# --------------------------------------------------------------------------

def to_bytes(obj) -> bytes:
    """Serialize any PVW object to its canonical byte form."""
    from ..crypto.encryption import PvwCiphertext
    from ..keys.public_key import GlobalPublicKey, PublicKey
    from ..keys.secret_key import SecretKey
    from ..params.crs import PvwCrs
    from ..params.parameters import PvwParameters
    from ..poly import Poly

    for cls, fn in ((PvwParameters, params_to_bytes), (Poly, poly_to_bytes),
                    (SecretKey, secret_key_to_bytes), (PvwCrs, crs_to_bytes),
                    (GlobalPublicKey, global_public_key_to_bytes),
                    (PublicKey, public_key_to_bytes), (PvwCiphertext, ciphertext_to_bytes)):
        if isinstance(obj, cls):
            return fn(obj)
    raise SerializationError(f"unsupported type {type(obj).__name__}")


_DECODERS = {
    "params": lambda d, dev: params_from_bytes(d),
    "poly": lambda d, dev: poly_from_bytes(d, device=dev),
    "secret_key": lambda d, dev: secret_key_from_bytes(d),
    "crs": lambda d, dev: crs_from_bytes(d, dev),
    "global_public_key": lambda d, dev: global_public_key_from_bytes(d, dev),
    "public_key": lambda d, dev: public_key_from_bytes(d, dev),
    "ciphertext": lambda d, dev: ciphertext_from_bytes(d, dev),
}


def from_bytes(data: bytes, device="cuda"):
    """Deserialize any PVWT blob by its embedded type tag."""
    t = _header(data).get("type")
    if t not in _DECODERS:
        raise DeserializationError(f"unknown type tag {t!r}")
    return _DECODERS[t](data, device)
