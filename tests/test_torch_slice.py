"""The port's slice end to end against the JAX package, on the CPU.

State is carried across with ``pvw_tpu_torch.convert`` (parameters, CRS,
secret keys, key words), so both packages compute keygen, encryption and
decryption from identical inputs at the ``toy`` preset (n=7, k=32, l=8, two
limbs). Residues and messages: exact equality. The port also reproduces
the golden hashes of ``tests/test_golden.py`` from the seeds alone.
"""

import ast
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import pvw_tpu as J
from pvw_tpu.config import settings as jsettings
from pvw_tpu.params import presets as jpresets
import pvw_tpu_torch as P
from pvw_tpu_torch import convert
from pvw_tpu_torch import random as R
from pvw_tpu_torch.config import settings as tsettings

ROOT = Path(__file__).resolve().parents[1]


def kw(jkey):
    return convert.key_from_words(np.asarray(jax.random.key_data(jkey)))


@pytest.fixture(scope="module")
def toy():
    jp = jpresets.toy()
    tp = convert.params_from_dict(jp.to_dict())
    jkey = jax.random.key(42)
    jcrs = J.PvwCrs.new(jp, jax.random.fold_in(jkey, 1))
    tcrs = convert.crs_from_residues(jcrs.matrix.residues_np(), tp, device="cpu")
    jparties = [J.Party.new(i, jp, jax.random.fold_in(jkey, 100 + i)) for i in range(jp.n)]
    tsks = [convert.secret_key_from_coeffs(p.secret_key.secret_coeffs, tp)
            for p in jparties]
    jgpk = J.GlobalPublicKey(jcrs)
    jgpk.generate_all_party_keys(jparties, jax.random.fold_in(jkey, 2))
    tgpk = P.GlobalPublicKey(tcrs)
    tgpk.generate_all_keys(tsks, kw(jax.random.fold_in(jkey, 2)))
    return jp, tp, jkey, jcrs, tcrs, jparties, tsks, jgpk, tgpk


def test_crs_and_secret_keys_from_keys_equal_jax(toy):
    jp, tp, jkey, jcrs, _, jparties, _, _, _ = toy
    tcrs = P.PvwCrs.new(tp, kw(jax.random.fold_in(jkey, 1)), device="cpu")
    np.testing.assert_array_equal(tcrs.matrix.residues_np(), jcrs.matrix.residues_np())
    np.testing.assert_array_equal(
        P.PvwCrs.new_from_tag(tp, "pvss-round-1", device="cpu").matrix.residues_np(),
        J.PvwCrs.new_from_tag(jp, "pvss-round-1").matrix.residues_np())
    for i, jpt in enumerate(jparties):
        tpt = P.Party.new(i, tp, kw(jax.random.fold_in(jkey, 100 + i)), device="cpu")
        np.testing.assert_array_equal(tpt.secret_key.secret_coeffs,
                                      jpt.secret_key.secret_coeffs)


def test_batch_keygen_equals_jax(toy, monkeypatch):
    from pvw_tpu_torch.keys import public_key

    _, tp, jkey, _, tcrs, _, tsks, jgpk, tgpk = toy
    assert tgpk.is_full()
    np.testing.assert_array_equal(tgpk.matrix.residues_np(), jgpk.matrix.residues_np())
    # keygen from a coefficient tensor in party chunks of 3, 3 and 1: e1
    # rows are keyed by global party index, so chunking changes nothing
    monkeypatch.setattr(public_key, "_keygen_chunk_size", lambda params: 3)
    coeffs = torch.from_numpy(np.stack([sk.secret_coeffs for sk in tsks]))
    gpk2 = P.GlobalPublicKey(tcrs)
    gpk2.generate_all_keys_device(coeffs, kw(jax.random.fold_in(jkey, 2)))
    np.testing.assert_array_equal(gpk2.matrix.residues_np(), jgpk.matrix.residues_np())


@pytest.mark.parametrize("stream,big", [("kernel", False), ("v3", True), ("v3k", True)])
def test_encrypt_batch_equals_jax(toy, stream, big):
    jp, _, jkey, _, _, _, _, jgpk, tgpk = toy
    rng = np.random.default_rng(31)
    top = (1 << 64) - 1 if big else (1 << 32) - 1
    sc = rng.integers(0, top, size=(3, jp.n), dtype=np.uint64, endpoint=True)
    if big:
        sc[0, :3] = [1 << 63, (1 << 64) - 1, 0]
    key = jax.random.fold_in(jkey, 7)
    try:
        jsettings.noise_stream = stream
        tsettings.noise_stream = stream
        jct = J.encrypt_batch(sc, jgpk, key)
        tct = P.encrypt_batch(sc, tgpk, kw(key))
    finally:
        del jsettings.noise_stream
        del tsettings.noise_stream
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())


def test_all_party_shares_round_trip_equals_jax(toy):
    jp, tp, jkey, _, tcrs, jparties, tsks, jgpk, _ = toy
    # the key matrix carried across as residues, too
    tgpk = convert.global_pk_from_residues(jgpk.matrix.residues_np(), tcrs)
    rng = np.random.default_rng(32)
    shares = rng.integers(0, 1 << 32, size=(jp.n, jp.n), dtype=np.uint64)
    key = jax.random.fold_in(jkey, 8)
    jct = J.encrypt_all_party_shares_batched(shares, jgpk, key)
    tct = P.encrypt_all_party_shares_batched(shares, tgpk, kw(key))
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
    listed = P.encrypt_all_party_shares(shares, tgpk, kw(key))
    try:
        jsettings.decode_mode = "python"
        for i in (0, 3, jp.n - 1):
            want = J.decrypt_party_shares(jct, jparties[i].secret_key, i)
            got = P.decrypt_party_shares(tct, tsks[i], i)
            assert got == want == [int(v) for v in shares[:, i]]
            assert P.decrypt_party_shares(listed, tsks[i], i) == got
    finally:
        del jsettings.decode_mode


def test_encrypt_and_decrypt_party_value_equal_jax(toy):
    jp, _, jkey, _, _, jparties, tsks, jgpk, tgpk = toy
    scalars = np.array([5, 0, 1 << 31, 123456789, 7, 2 ** 40 + 3, 1], np.uint64)
    key = jax.random.fold_in(jkey, 9)
    jct = J.encrypt(scalars, jgpk, key)
    tct = P.encrypt(scalars, tgpk, kw(key))
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
    try:
        jsettings.decode_mode = "python"
        for i in range(jp.n):
            got = P.decrypt_party_value(tct, tsks[i], i)
            assert got == J.decrypt_party_value(jct, jparties[i].secret_key, i) == int(scalars[i])
    finally:
        del jsettings.decode_mode


def test_party_shares_and_broadcast_equal_jax(toy):
    jp, _, jkey, _, _, jparties, tsks, jgpk, tgpk = toy
    shares = np.arange(100, 100 + jp.n, dtype=np.uint64)
    key = jax.random.fold_in(jkey, 10)
    cases = ((J.encrypt_party_shares(shares, 2, jgpk, key),
              P.encrypt_party_shares(shares, 2, tgpk, kw(key)), shares),
             (J.encrypt_broadcast(1 << 33, jgpk, key),
              P.encrypt_broadcast(1 << 33, tgpk, kw(key)), [1 << 33] * jp.n))
    for jct, tct, want in cases:
        np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
        np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
        for i in (0, jp.n - 1):
            assert P.decrypt_party_value(tct, tsks[i], i) == int(want[i])
    with pytest.raises(P.errors.InvalidParameters, match="exceeds maximum"):
        P.encrypt_party_shares(shares, jp.n, tgpk, kw(key))


def test_keygen_residue_ntt_path_equals_signed_path(toy):
    """Coefficients beyond the signed-digit range take the residue NTT
    route of the keygen kernel; both routes are exact, so a forced large
    bound must give the same keys."""
    _, _, jkey, _, tcrs, _, tsks, _, tgpk = toy
    coeffs = torch.from_numpy(np.stack([sk.secret_coeffs for sk in tsks]))
    gpk = P.GlobalPublicKey(tcrs)
    gpk.generate_all_keys_device(coeffs, kw(jax.random.fold_in(jkey, 2)),
                                 coeff_bound=1 << 40)
    np.testing.assert_array_equal(gpk.matrix.residues_np(), tgpk.matrix.residues_np())


def test_unported_paths_raise_clearly(toy):
    """A bound above the signed-digit range (the residue-noise path)
    encrypts as the JAX package does; every decode engine (device, and the
    C++ engine's host and native modes) decodes the JAX package's
    messages."""
    jp, tp, jkey, jcrs, tcrs, jparties, tsks, jgpk, tgpk = toy
    sc = np.arange(jp.n * jp.n, dtype=np.uint64).reshape(jp.n, jp.n)
    big = dict(tp.to_dict(), error_bound_2="40000")
    bgpk = convert.global_pk_from_residues(tgpk.matrix.residues_np(), P.PvwCrs(
        tcrs.matrix, convert.params_from_dict(big)))
    jbgpk = J.GlobalPublicKey(J.PvwCrs(jcrs.matrix, J.PvwParameters.from_dict(big)))
    jbgpk.matrix, jbgpk.num_keys = jgpk.matrix, jp.n
    key = jax.random.fold_in(jkey, 11)
    tct = P.encrypt_batch(sc, bgpk, kw(key))
    jct = J.encrypt_batch(sc, jbgpk, key)
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
    assert P.decrypt_party_shares(tct, tsks[1], 1) == [int(v) for v in sc[:, 1]]
    key = jax.random.fold_in(jkey, 12)
    scalars = np.arange(jp.n, dtype=np.uint64) * 7919
    ct, jct = P.encrypt(scalars, tgpk, kw(key)), J.encrypt(scalars, jgpk, key)
    try:
        for mode in ("device", "host", "native"):
            tsettings.decode_mode = jsettings.decode_mode = mode
            for i in (0, jp.n - 1):
                want = J.decrypt_party_value(jct, jparties[i].secret_key, i)
                assert P.decrypt_party_value(ct, tsks[i], i) == want == int(scalars[i])
    finally:
        del tsettings.decode_mode, jsettings.decode_mode
    assert P.decrypt_party_value(ct, tsks[0], 0) == 0


# --------------------------------------------------------------------------
# golden hashes from seeds alone (tests/test_golden.py's system)
# --------------------------------------------------------------------------

GOLDEN_MODULI = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)


def _h(arr):
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]


@pytest.fixture(scope="module")
def golden():
    b1, b2 = P.PvwParameters.suggest_error_bounds(4, 8, 8, GOLDEN_MODULI, 0.5)
    p = (P.PvwParametersBuilder().set_parties(4).set_dimension(8).set_l(8)
         .set_moduli(GOLDEN_MODULI).set_secret_variance(0.5)
         .set_error_bounds_u32(b1, b2).build())
    key = R.key(1234)
    crs = P.PvwCrs.new_deterministic(p, bytes(range(32)), device="cpu")
    parties = [P.Party.new(i, p, R.fold_in(key, i), device="cpu") for i in range(4)]
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, R.fold_in(key, 99))
    sc = np.arange(2 * p.n, dtype=np.uint64).reshape(2, p.n)
    ct = P.encrypt_batch(sc, gpk, R.fold_in(key, 7))
    return {
        "crs": crs.matrix.residues_np(),
        "secret_key": np.stack([pt.secret_key.secret_coeffs for pt in parties]),
        "global_pk": gpk.matrix.residues_np(),
        "c1": ct.c1.residues_np(),
        "c2": ct.c2.residues_np(),
    }


@pytest.mark.parametrize("name,digest", [
    ("crs", "87295f5306ea364d"),
    ("secret_key", "d3bc51f25628c4f5"),
    ("global_pk", "8d40adf52c1c9af2"),
    ("c1", "9c7654078768ba8f"),
    ("c2", "2d627fd108fc81bd"),
])
def test_golden_hashes(golden, name, digest):
    assert _h(golden[name]) == digest


# --------------------------------------------------------------------------
# the package stands alone
# --------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_the_jax_package():
    bad = []
    for path in sorted((ROOT / "pvw_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "pvw_tpu")]
    assert bad == []
    script = ("import sys; sys.modules['jax'] = None; sys.modules['pvw_tpu'] = None\n"
              "import pvw_tpu_torch\n"
              "assert pvw_tpu_torch.demo_roundtrip(verbose=False, device='cpu')\n"
              "print('isolated-ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT / "tests",
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "isolated-ok" in out.stdout


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    tp = convert.params_from_dict(jpresets.toy(3).to_dict())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.PvwCrs.new(tp, R.key(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.Party.new(0, tp, R.key(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.demo_roundtrip(verbose=False)
