"""PVWT bytes of the port against the JAX package's, for all 7 types.

For the same seeds both packages must write the same bytes, and each must
load the other's bytes and write them again unchanged. Round-tripped
ciphertexts must still decrypt; malformed blobs, limb-restricted views and
unknown types must be refused (the cases of ``tests/test_serialization.py``).
"""

import json

import numpy as np
import jax
import pytest

import pvw_tpu as J
from pvw_tpu.utils import serialization as jser
import pvw_tpu_torch as P
from pvw_tpu_torch import convert
from pvw_tpu_torch.errors import (DeserializationError, InsufficientData, InvalidFormat,
                                  SerializationError)
from pvw_tpu_torch.utils import serialization as tser

MODULI = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


@pytest.fixture(scope="module")
def system():
    """One object of each type in both packages, the port's made from the
    same seeds (keys, encryptions) or carried across (CRS, coefficients)."""
    n, k, l = 3, 4, 8
    b1, b2 = J.PvwParameters.suggest_error_bounds(n, k, l, MODULI, 0.5)
    jp = (J.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
          .set_moduli(MODULI).set_secret_variance(0.5).set_error_bounds_u32(b1, b2).build())
    tp = convert.params_from_dict(jp.to_dict())
    key = jax.random.key(0)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(key, 0))
    tcrs = P.PvwCrs.new(tp, kw(jax.random.fold_in(key, 0)), device="cpu")
    jparties = [J.Party.new(i, jp, jax.random.fold_in(key, 100 + i)) for i in range(n)]
    tparties = [P.Party.new(i, tp, kw(jax.random.fold_in(key, 100 + i)), device="cpu")
                for i in range(n)]
    jgpk, tgpk = J.GlobalPublicKey(jcrs), P.GlobalPublicKey(tcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(key, 1))
    tgpk.generate_all_party_keys(tparties, kw(jax.random.fold_in(key, 1)))
    ekey = jax.random.key(9)
    jgpk.generate_and_add_with_errors(1, jparties[1].secret_key, ekey)
    tgpk.generate_and_add_with_errors(1, tparties[1].secret_key, kw(ekey))
    scalars = [5, 6, 7]
    jct = J.encrypt(scalars, jgpk, jax.random.key(11))
    tct = P.encrypt(scalars, tgpk, kw(jax.random.key(11)))
    sc = np.arange(9, dtype=np.uint64).reshape(3, 3) * 1000 + 1
    jbct = J.encrypt_batch(sc, jgpk, jax.random.key(12))
    tbct = P.encrypt_batch(sc, tgpk, kw(jax.random.key(12)))
    jpoly = J.Poly.random(jp.ring, J.Representation.Ntt, jax.random.key(1), (2,))
    tpoly = P.Poly.random(tp.ring, P.Representation.Ntt, kw(jax.random.key(1)), (2,),
                          device="cpu")
    objects = {
        "params": (jp, tp),
        "poly": (jpoly, tpoly),
        "power_poly": (jpoly.to_power_basis(), tpoly.to_power_basis()),
        "secret_key": (jparties[2].secret_key, tparties[2].secret_key),
        "crs": (jcrs, tcrs),
        "public_key": (jgpk.get_public_key(0), tgpk.get_public_key(0)),
        "global_public_key": (jgpk, tgpk),
        "ciphertext": (jct, tct),
        "batched_ciphertext": (jbct, tbct),
    }
    return dict(objects=objects, jparties=jparties, tparties=tparties, scalars=scalars,
                sc=sc, tp=tp, jp=jp)


TYPES = ["params", "poly", "power_poly", "secret_key", "crs", "public_key",
         "global_public_key", "ciphertext", "batched_ciphertext"]
LOADERS = {"params": "PvwParameters", "poly": "Poly", "power_poly": "Poly",
           "secret_key": "SecretKey", "crs": "PvwCrs", "public_key": "PublicKey",
           "global_public_key": "GlobalPublicKey", "ciphertext": "PvwCiphertext",
           "batched_ciphertext": "PvwCiphertext"}


def port_load(name, blob):
    cls = getattr(P, LOADERS[name])
    if name in ("params", "secret_key"):
        return cls.from_bytes(blob)
    return cls.from_bytes(blob, device="cpu")


@pytest.mark.parametrize("name", TYPES)
def test_port_bytes_equal_jax_bytes(system, name):
    jobj, tobj = system["objects"][name]
    blob = jobj.to_bytes()
    assert tobj.to_bytes() == blob
    assert tser.to_bytes(tobj) == blob


@pytest.mark.parametrize("name", TYPES)
def test_jax_bytes_load_in_port(system, name):
    jobj, _ = system["objects"][name]
    blob = jobj.to_bytes()
    loaded = port_load(name, blob)
    assert isinstance(loaded, getattr(P, LOADERS[name]))
    assert loaded.to_bytes() == blob
    generic = tser.from_bytes(blob, device="cpu")
    assert type(generic) is type(loaded) and tser.to_bytes(generic) == blob


@pytest.mark.parametrize("name", TYPES)
def test_port_bytes_load_in_jax(system, name):
    _, tobj = system["objects"][name]
    blob = tobj.to_bytes()
    loaded = getattr(J, LOADERS[name]).from_bytes(blob)
    assert loaded.to_bytes() == blob
    assert jser.to_bytes(jser.from_bytes(blob)) == blob


def test_loaded_objects_validate_and_keep_their_fields(system):
    objs = system["objects"]
    gpk = P.GlobalPublicKey.from_bytes(objs["global_public_key"][1].to_bytes(), device="cpu")
    gpk.validate()
    gpk.crs.validate()
    assert gpk.num_keys == objs["global_public_key"][0].num_keys
    assert gpk.get_party_errors(0) is None
    np.testing.assert_array_equal(gpk.get_party_errors(1).residues_np(),
                                  objs["global_public_key"][0].get_party_errors(1).residues_np())
    assert P.Poly.from_bytes(objs["power_poly"][0].to_bytes(), device="cpu").rep == \
        P.Representation.PowerBasis
    assert P.PvwParameters.from_bytes(objs["params"][0].to_bytes()).delta() == \
        system["tp"].delta()
    sk = P.SecretKey.from_bytes(objs["secret_key"][0].to_bytes())
    np.testing.assert_array_equal(sk.secret_coeffs, objs["secret_key"][1].secret_coeffs)
    P.PublicKey.from_bytes(objs["public_key"][0].to_bytes(), device="cpu").validate()


def test_decrypt_after_round_trip(system):
    """Round-tripped ciphertexts (from either package) validate and decrypt
    with round-tripped keys; the loaded global key encrypts the same bytes."""
    objs = system["objects"]
    for blob in (objs["ciphertext"][0].to_bytes(), objs["ciphertext"][1].to_bytes()):
        ct = P.PvwCiphertext.from_bytes(blob, device="cpu")
        ct.validate()
        for i, party in enumerate(system["tparties"]):
            sk = P.SecretKey.from_bytes(party.secret_key.to_bytes())
            assert P.decrypt_party_value(ct, sk, i) == system["scalars"][i]
    bct = P.PvwCiphertext.from_bytes(objs["batched_ciphertext"][0].to_bytes(), device="cpu")
    assert P.decrypt_party_shares(bct, system["tparties"][2].secret_key, 2) == \
        [int(v) for v in system["sc"][:, 2]]
    gpk = P.GlobalPublicKey.from_bytes(objs["global_public_key"][1].to_bytes(), device="cpu")
    again = P.encrypt(system["scalars"], gpk, kw(jax.random.key(11)))
    assert again.to_bytes() == objs["ciphertext"][1].to_bytes()


def test_bytes_are_deterministic_and_stable(system):
    objs = system["objects"]
    tp = system["tp"]
    assert tp.to_bytes() == tp.to_bytes()
    b1 = objs["global_public_key"][1].to_bytes()
    assert P.GlobalPublicKey.from_bytes(b1, device="cpu").to_bytes() == b1
    blob = objs["crs"][1].to_bytes()
    assert blob[:4] == b"PVWT" and blob[4] == 1
    hlen = int.from_bytes(blob[5:9], "little")
    header = json.loads(blob[9:9 + hlen])
    assert json.dumps(header, sort_keys=True, separators=(",", ":")).encode() == blob[9:9 + hlen]
    assert header["type"] == "crs" and header["sections"]["dtypes"] == ["<u8"]
    assert len(blob) == 9 + hlen + objs["crs"][1].matrix.residues_np().nbytes


def test_malformed_blobs_are_refused(system):
    objs = system["objects"]
    with pytest.raises(InvalidFormat):
        tser.from_bytes(b"nope" + bytes(20))
    with pytest.raises(InvalidFormat, match="version"):
        tser.crs_from_bytes(b"PVWT\x02" + bytes(8))
    with pytest.raises(DeserializationError, match="expected type"):
        tser.crs_from_bytes(objs["params"][1].to_bytes())
    with pytest.raises(DeserializationError, match="bad header"):
        tser.from_bytes(b"PVWT\x01" + (4).to_bytes(4, "little") + b"{{{{")
    with pytest.raises(DeserializationError, match="unknown type"):
        tser.from_bytes(tser._pack("bogus", {}, []))
    blob = objs["secret_key"][1].to_bytes()
    with pytest.raises(InsufficientData, match="Insufficient data") as e:
        tser.secret_key_from_bytes(blob[:len(blob) - 4])
    assert e.value.actual == len(blob) - 4 and e.value.expected > e.value.actual
    with pytest.raises(InsufficientData):
        tser.params_from_bytes(blob[:12])
    with pytest.raises(SerializationError, match="unsupported type"):
        tser.to_bytes(object())


def test_restricted_view_refuses_serialization(system):
    tp = system["tp"]
    view = tp.restrict_limbs((0, 1))
    with pytest.raises(SerializationError):
        view.to_dict()
    with pytest.raises(SerializationError):
        view.to_bytes()
    assert P.PvwParameters.from_bytes(tp.to_bytes()) == tp
