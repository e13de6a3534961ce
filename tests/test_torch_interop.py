"""The port's ``pvw-vectors-v1`` exchange against the JAX package's.

A case dumped by either package must load in the other (and dump to the
same dict), a foreign NTT slot order must be solved from its probe and
bridged exactly, and malformed cases must be refused (the cases of
``tests/test_interop.py`` and the synthetic foreign implementation of
``tests/test_vectors.py``).
"""

import json

import numpy as np
import jax
import pytest

import pvw_tpu as J
from pvw_tpu import interop as jinterop
import pvw_tpu_torch as P
from pvw_tpu_torch import convert, interop
from pvw_tpu_torch.errors import InvalidParameters, SerializationError

MODULI = (0xFFFFC4001, 0x1FFFFE0001)


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


@pytest.fixture(scope="module")
def system():
    """n = 3, k = 16 in both packages from the same seeds, and one
    ciphertext of three scalars each."""
    n, k, l = 3, 16, 8
    b1, b2 = J.PvwParameters.suggest_error_bounds(n, k, l, MODULI, 0.5)
    jp = (J.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
          .set_moduli(MODULI).set_secret_variance(0.5).set_error_bounds_u32(b1, b2).build())
    tp = convert.params_from_dict(jp.to_dict())
    key = jax.random.key(3)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(key, 0))
    tcrs = P.PvwCrs.new(tp, kw(jax.random.fold_in(key, 0)), device="cpu")
    jparties = [J.Party.new(i, jp, jax.random.fold_in(key, 10 + i)) for i in range(n)]
    tparties = [P.Party.new(i, tp, kw(jax.random.fold_in(key, 10 + i)), device="cpu")
                for i in range(n)]
    jgpk, tgpk = J.GlobalPublicKey(jcrs), P.GlobalPublicKey(tcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(key, 1))
    tgpk.generate_all_party_keys(tparties, kw(jax.random.fold_in(key, 1)))
    scalars = [11, 22, 33]
    ekey = jax.random.fold_in(key, 2)
    return dict(jp=jp, tp=tp, jcrs=jcrs, tcrs=tcrs, jparties=jparties, tparties=tparties,
                scalars=scalars, jct=J.encrypt(scalars, jgpk, ekey),
                tct=P.encrypt(scalars, tgpk, kw(ekey)))


def dumps(s, pkg):
    p = "t" if pkg is interop else "j"
    return pkg.dump_case(s[p + "p"], crs=s[p + "crs"],
                         secret_keys=[q.secret_key for q in s[p + "parties"]],
                         ciphertext=s[p + "ct"], scalars=s["scalars"], plaintexts=s["scalars"])


def test_port_dumps_the_jax_case(system):
    assert dumps(system, interop) == dumps(system, jinterop)


def test_jax_case_loads_in_port(system, tmp_path):
    path = str(tmp_path / "case.json")
    jinterop.dump_case(system["jp"], crs=system["jcrs"],
                       secret_keys=[p.secret_key for p in system["jparties"]],
                       ciphertext=system["jct"], scalars=system["scalars"],
                       plaintexts=system["scalars"], path=path)
    loaded = interop.load_case(path, device="cpu")
    assert loaded.params == system["tp"]
    assert loaded.bridge.perms == [list(range(8))] * 2
    np.testing.assert_array_equal(loaded.crs.matrix.residues_np(),
                                  system["jcrs"].matrix.residues_np())
    assert loaded.scalars == loaded.plaintexts == system["scalars"]
    for i, sk in enumerate(loaded.secret_keys):
        np.testing.assert_array_equal(sk.coefficients(),
                                      system["jparties"][i].secret_key.coefficients())
        assert P.decrypt_party_value(loaded.ciphertext, sk, i) == system["scalars"][i]


def test_port_case_loads_in_jax(system, tmp_path):
    path = str(tmp_path / "case.json")
    interop.dump_case(system["tp"], crs=system["tcrs"],
                      secret_keys=[p.secret_key for p in system["tparties"]],
                      ciphertext=system["tct"], scalars=system["scalars"],
                      plaintexts=system["scalars"], path=path)
    with open(path) as f:
        assert json.load(f)["schema"] == "pvw-vectors-v1"
    loaded = jinterop.load_case(path)
    assert loaded.params == system["jp"]
    np.testing.assert_array_equal(loaded.crs.matrix.residues_np(),
                                  system["tcrs"].matrix.residues_np())
    for i, sk in enumerate(loaded.secret_keys):
        assert J.decrypt_party_value(loaded.ciphertext, sk, i) == system["scalars"][i]


def foreign_order(params, seed):
    """A foreign slot order (a random permutation per limb) and its probe:
    slot s evaluates at psi^(2 sigma[s] + 1)."""
    rng = np.random.default_rng(seed)
    sigma = [[int(v) for v in rng.permutation(params.l)] for _ in params.ring.moduli]
    probe = [[str(pow(limb.psi, 2 * sigma[i][s] + 1, limb.q)) for s in range(params.l)]
             for i, limb in enumerate(params.ring.limbs)]
    return sigma, probe


def test_foreign_order_round_trip(system):
    tp = system["tp"]
    sigma, probe = foreign_order(tp, 5)
    foreign = interop.NttBridge(sigma)
    crs_d = interop.export_crs(system["tcrs"], bridge=foreign)
    ct_d = interop.export_ciphertext(system["tct"], bridge=foreign)
    assert crs_d == jinterop.export_crs(system["jcrs"], bridge=jinterop.NttBridge(sigma))
    solved = interop.solve_ntt_bridge(tp, {"x_monomial_ntt": probe})
    assert solved.perms == sigma == jinterop.solve_ntt_bridge(
        system["jp"], {"x_monomial_ntt": probe}).perms
    crs2 = interop.load_crs(crs_d, tp, solved, device="cpu")
    np.testing.assert_array_equal(crs2.matrix.residues_np(), system["tcrs"].matrix.residues_np())
    ct2 = interop.load_ciphertext(ct_d, tp, solved, device="cpu")
    for i, party in enumerate(system["tparties"]):
        assert P.decrypt_party_value(ct2, party.secret_key, i) == system["scalars"][i]


def test_synthetic_foreign_implementation(system):
    """A foreign implementation's residues (our residues in its slot order)
    are bridged back exactly and its ciphertext decrypts."""
    tp = system["tp"]
    sigma, probe = foreign_order(tp, 7)
    bridge = interop.solve_ntt_bridge(tp, probe)
    assert bridge.perms == sigma
    c1_f = jinterop.NttBridge(sigma).to_foreign(system["tct"].c1.residues_np())
    c2_f = jinterop.NttBridge(sigma).to_foreign(system["tct"].c2.residues_np())
    ct = P.PvwCiphertext(P.Poly.from_residues_np(bridge.to_ours(c1_f), tp.ring,
                                                 P.Representation.Ntt, device="cpu"),
                         P.Poly.from_residues_np(bridge.to_ours(c2_f), tp.ring,
                                                 P.Representation.Ntt, device="cpu"), tp)
    for i, party in enumerate(system["tparties"]):
        assert P.decrypt_party_value(ct, party.secret_key, i) == system["scalars"][i]


def test_bridge_inverse(system):
    rng = np.random.default_rng(1)
    sigma = [[int(v) for v in rng.permutation(8)] for _ in MODULI]
    b, jb = interop.NttBridge(sigma), jinterop.NttBridge(sigma)
    res = rng.integers(0, 1 << 34, (5, len(sigma), 8), np.uint64)
    np.testing.assert_array_equal(b.to_ours(b.to_foreign(res)), res)
    np.testing.assert_array_equal(b.to_foreign(b.to_ours(res)), res)
    np.testing.assert_array_equal(b.to_ours(res), jb.to_ours(res))
    np.testing.assert_array_equal(b.to_foreign(res), jb.to_foreign(res))
    ident = interop.NttBridge.identity(system["tp"])
    np.testing.assert_array_equal(ident.to_ours(res), res)


def test_schema_and_probe_errors(system):
    tp = system["tp"]
    with pytest.raises(SerializationError, match="unknown schema"):
        interop.load_case({"schema": "bogus"})
    bad = [["1"] * tp.l for _ in tp.ring.moduli]             # 1 is not a root
    with pytest.raises(SerializationError, match="primitive"):
        interop.solve_ntt_bridge(tp, {"x_monomial_ntt": bad})
    dup = [[str(tp.ring.limbs[i].psi)] * tp.l for i in range(2)]
    with pytest.raises(SerializationError, match="bijection"):
        interop.solve_ntt_bridge(tp, dup)
    with pytest.raises(InvalidParameters, match="k\\*k"):
        interop.load_crs({"ntt_residues": []}, tp, device="cpu")
    batched = P.PvwCiphertext(P.Poly.zero(tp.ring, batch=(tp.k, 2), device="cpu"),
                              P.Poly.zero(tp.ring, batch=(tp.n, 2), device="cpu"), tp)
    with pytest.raises(InvalidParameters, match="unbatched"):
        interop.export_ciphertext(batched)


def test_params_export_fields_match_schema(system):
    d = interop.export_params(system["tp"])
    assert d == jinterop.export_params(system["jp"])
    assert set(d) == {"n", "k", "l", "moduli", "secret_variance", "error_bound_1",
                      "error_bound_2"}
    assert interop.load_params(d) == system["tp"]
    assert interop.ntt_probe(system["tp"]) == jinterop.ntt_probe(system["jp"])
