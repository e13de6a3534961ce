"""Value-level interop with pvw-rs: the ``pvw-vectors-v1`` exchange format.

The counterpart of ``pvw_tpu.interop`` (schema in
``tests/vectors/README.md``): parameters, CRS, secret keys and ciphertexts
exported and loaded by value, every integer a decimal string. NTT residues
travel with a solved convention bridge: a case carries the NTT of the
monomial X (``ntt_probe``), from which :func:`solve_ntt_bridge` derives
the exact slot permutation between the writer's NTT order and ours (slot
j evaluates at psi^(2j+1)). The objects a case loads into are built on
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

from .errors import InvalidParameters, SerializationError

SCHEMA = "pvw-vectors-v1"


# --------------------------------------------------------------------------
# NTT convention bridge
# --------------------------------------------------------------------------

class NttBridge:
    """Slot permutation between a foreign NTT convention and ours:
    ``perms[i][s]`` is our slot for foreign slot ``s`` of limb i."""

    def __init__(self, perms: list[list[int]]) -> None:
        self.perms = perms

    @classmethod
    def identity(cls, params) -> "NttBridge":
        ring = params.ring
        return cls([list(range(ring.degree)) for _ in range(ring.num_limbs)])

    def to_ours(self, res: np.ndarray) -> np.ndarray:
        """Foreign-order NTT residues [..., L, l] -> our slot order."""
        out = np.zeros_like(res)
        for i, perm in enumerate(self.perms):
            out[..., i, perm] = res[..., i, :]
        return out

    def to_foreign(self, res: np.ndarray) -> np.ndarray:
        """Our NTT residues [..., L, l] -> the foreign slot order."""
        out = np.zeros_like(res)
        for i, perm in enumerate(self.perms):
            out[..., i, :] = res[..., i, perm]
        return out


def ntt_probe(params) -> list[list[str]]:
    """Our ``ntt_probe`` section: the NTT of the monomial X per limb, slot j
    holding psi^(2j+1)."""
    return [[str(pow(limb.psi, 2 * j + 1, limb.q)) for j in range(params.ring.degree)]
            for limb in params.ring.limbs]


def solve_ntt_bridge(params, probe) -> NttBridge:
    """The exact foreign -> ours slot permutation from a dumped NTT of X
    (``ntt_probe.x_monomial_ntt``): each slot's value is its evaluation
    point, a primitive 2l-th root of unity, whose discrete log base our psi
    names the slot. Raises :class:`SerializationError` for a value that is
    no such root (a scaled NTT form) or a map that is no bijection."""
    rows = probe["x_monomial_ntt"] if isinstance(probe, dict) else probe
    ring = params.ring
    perms = []
    for i, limb in enumerate(ring.limbs):
        pow_to_exp = {pow(limb.psi, e, limb.q): e for e in range(1, 2 * ring.degree, 2)}
        perm = []
        for s in range(ring.degree):
            v = int(rows[i][s])
            if v not in pow_to_exp:
                raise SerializationError(
                    f"ntt_probe limb {i} slot {s}: {v} is not a primitive "
                    "2l-th root of unity mod q — the foreign NTT is stored "
                    "in a scaled form; extend the bridge with its scale")
            perm.append((pow_to_exp[v] - 1) // 2)
        if sorted(perm) != list(range(ring.degree)):
            raise SerializationError(f"ntt_probe limb {i}: slot map is not a bijection")
        perms.append(perm)
    return NttBridge(perms)


def _res_to_json(res: np.ndarray) -> list[list[str]]:
    """uint64 [L, l] -> nested decimal strings."""
    return [[str(int(v)) for v in row] for row in np.asarray(res)]


def _res_from_json(rows) -> np.ndarray:
    return np.array([[int(v) for v in row] for row in rows], np.uint64)


# --------------------------------------------------------------------------
# per-type export / load
# --------------------------------------------------------------------------

def export_params(params) -> dict:
    return {
        "n": params.n, "k": params.k, "l": params.l,
        "moduli": [str(m) for m in params.ring.moduli],
        "secret_variance": params.secret_variance,
        "error_bound_1": str(params.error_bound_1),
        "error_bound_2": str(params.error_bound_2),
    }


def load_params(d: dict):
    from .params.parameters import PvwParametersBuilder

    b = (PvwParametersBuilder().set_parties(int(d["n"])).set_dimension(int(d["k"]))
         .set_l(int(d["l"])).set_moduli(tuple(int(m) for m in d["moduli"])))
    if "secret_variance" in d:
        b.set_secret_variance(float(d["secret_variance"]))
    if "error_bound_1" in d:
        b.set_error_bounds_u32(int(d["error_bound_1"]), int(d["error_bound_2"]))
    return b.build()


def export_crs(crs, bridge: Optional[NttBridge] = None) -> dict:
    """CRS -> the schema's ``crs`` section (NTT residues in the bridge's
    order; ours without one)."""
    res = crs.matrix.residues_np()                       # [k, k, L, l]
    flat = res.reshape(-1, *res.shape[2:])
    if bridge is not None:
        flat = bridge.to_foreign(flat)
    return {"ntt_residues": [_res_to_json(r) for r in flat]}


def load_crs(d: dict, params, bridge: Optional[NttBridge] = None, device="cuda"):
    from .params.crs import PvwCrs
    from .poly import Poly, Representation

    k = params.k
    rows = d["ntt_residues"]
    if len(rows) != k * k:
        raise InvalidParameters(
            f"crs.ntt_residues must hold k*k={k * k} entries, got {len(rows)}")
    res = np.stack([_res_from_json(r) for r in rows])
    if bridge is not None:
        res = bridge.to_ours(res)
    res = res.reshape(k, k, params.ring.num_limbs, params.l)
    return PvwCrs(Poly.from_residues_np(res, params.ring, Representation.Ntt, device=device),
                  params)


def export_secret_key(sk) -> dict:
    return {"coeffs": [[int(c) for c in row] for row in sk.coefficients()]}


def load_secret_key(d: dict, params):
    from .keys.secret_key import SecretKey

    return SecretKey.from_coefficients(params, np.array(d["coeffs"], np.int64))


def export_ciphertext(ct, bridge: Optional[NttBridge] = None,
                      scalars: Optional[Sequence[int]] = None,
                      plaintexts: Optional[Sequence[int]] = None) -> dict:
    """One unbatched ciphertext -> the schema's ``ciphertext`` section."""
    c1 = ct.c1.residues_np()                             # [k, L, l]
    c2 = ct.c2.residues_np()                             # [n, L, l]
    if c1.ndim != 3:
        raise InvalidParameters(
            "export_ciphertext takes an unbatched ciphertext; export "
            "batched ones per dealer column")
    if bridge is not None:
        c1 = bridge.to_foreign(c1)
        c2 = bridge.to_foreign(c2)
    out = {"c1_ntt": [_res_to_json(r) for r in c1], "c2_ntt": [_res_to_json(r) for r in c2]}
    if scalars is not None:
        out["scalars"] = [str(int(s)) for s in scalars]
    if plaintexts is not None:
        out["plaintexts"] = [str(int(p)) for p in plaintexts]
    return out


def load_ciphertext(d: dict, params, bridge: Optional[NttBridge] = None, device="cuda"):
    from .crypto.encryption import PvwCiphertext
    from .poly import Poly, Representation

    c1 = np.stack([_res_from_json(r) for r in d["c1_ntt"]])
    c2 = np.stack([_res_from_json(r) for r in d["c2_ntt"]])
    if bridge is not None:
        c1 = bridge.to_ours(c1)
        c2 = bridge.to_ours(c2)
    ct = PvwCiphertext(Poly.from_residues_np(c1, params.ring, Representation.Ntt, device=device),
                       Poly.from_residues_np(c2, params.ring, Representation.Ntt, device=device),
                       params)
    ct.validate()
    return ct


# --------------------------------------------------------------------------
# whole cases
# --------------------------------------------------------------------------

def dump_case(params, crs=None, secret_keys=None, ciphertext=None, scalars=None,
              plaintexts=None, source: str = "pvw-tpu", path: Optional[str] = None) -> dict:
    """A complete ``pvw-vectors-v1`` case (written to ``path`` if given),
    with our ``ntt_probe`` so that any reader can solve the bridge against
    its own NTT."""
    case = {
        "schema": SCHEMA,
        "source": source,
        "params": export_params(params),
        "ntt_probe": {"x_monomial_ntt": ntt_probe(params)},
        "delta": str(params.delta()),
        "gadget_powerbasis": _res_to_json(
            params.gadget_polynomial(device="cpu").to_power_basis().residues_np()),
    }
    if crs is not None:
        case["crs"] = export_crs(crs)
    if secret_keys is not None:
        case["secret_keys"] = [export_secret_key(sk) for sk in secret_keys]
    if ciphertext is not None:
        case["ciphertext"] = export_ciphertext(ciphertext, scalars=scalars,
                                               plaintexts=plaintexts)
    if path is not None:
        with open(path, "w") as f:
            json.dump(case, f)
    return case


class LoadedCase:
    """A parsed ``pvw-vectors-v1`` case: params, the solved bridge and the
    objects, on ``device``."""

    def __init__(self, case: dict, device="cuda") -> None:
        if case.get("schema") != SCHEMA:
            raise SerializationError(f"unknown schema {case.get('schema')!r} (want {SCHEMA})")
        self.raw = case
        self.params = load_params(case["params"])
        self.bridge = (solve_ntt_bridge(self.params, case["ntt_probe"])
                       if "ntt_probe" in case else NttBridge.identity(self.params))
        self.crs = (load_crs(case["crs"], self.params, self.bridge, device)
                    if "crs" in case else None)
        self.secret_keys = [load_secret_key(d, self.params)
                            for d in case.get("secret_keys", [])]
        self.ciphertext = (load_ciphertext(case["ciphertext"], self.params, self.bridge,
                                           device) if "ciphertext" in case else None)
        cd = case.get("ciphertext", {})
        self.plaintexts = [int(p) for p in cd.get("plaintexts", [])]
        self.scalars = [int(s) for s in cd.get("scalars", [])]


def load_case(path_or_dict, device="cuda") -> LoadedCase:
    """A case from a JSON file path or an already parsed dict."""
    if isinstance(path_or_dict, dict):
        return LoadedCase(path_or_dict, device)
    with open(path_or_dict) as f:
        return LoadedCase(json.load(f), device)
