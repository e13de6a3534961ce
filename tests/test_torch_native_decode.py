"""The port's bridge to the C++ decode engine against the JAX package's.

``pvw_tpu_torch.utils.native_decode`` builds ``native/pvw_decode.cpp`` into
``build/native/`` and decodes through it; every message must equal the JAX
package's ``decode_batch_native`` and the Python decode of both packages,
on random residues, encodings of messages, edge rows and the boundaries of
a deep chain (the cases of ``tests/test_native_decode.py``). A failed
build raises; nothing falls back to the Python decode.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from pvw_tpu import PvwParameters, PvwParametersBuilder
from pvw_tpu.crypto.decryption import decode_scalar_pvw_rns as jdecode
from pvw_tpu.utils import native_decode as jnd
from pvw_tpu.utils.intmath import generate_ntt_primes
from pvw_tpu_torch import convert
from pvw_tpu_torch.crypto import decryption as tdec
from pvw_tpu_torch.ops import u64
from pvw_tpu_torch.utils import native_decode as tnd

ROOT = Path(__file__).resolve().parents[1]
MODULI3 = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)
MODULI55 = (0x800000022A0001, 0x800000021A0001, 0x80000002120001, 0x80000001F60001)


def make_params(n=3, k=4, l=8, moduli=MODULI3):
    b1, b2 = PvwParameters.suggest_error_bounds(n, k, l, moduli, 0.5)
    return (PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
            .set_moduli(moduli).set_secret_variance(0.5)
            .set_error_bounds_u32(b1, b2).build())


def port(jp):
    return convert.params_from_dict(jp.to_dict())


def decode_all_ways(jp, res):
    """(port engine, JAX engine, port Python decode, JAX Python decode)."""
    tp = port(jp)
    return (tnd.decode_batch_native(res, tp), jnd.decode_batch_native(res, jp),
            [tdec.decode_scalar_pvw_rns(r, tp) for r in res], [jdecode(r, jp) for r in res])


@pytest.mark.parametrize("moduli,l", [(MODULI3, 8), (MODULI3, 16), (MODULI55, 8),
                                      (MODULI3, 32)])
def test_native_matches_jax_on_random_residues(moduli, l):
    jp = make_params(l=l, moduli=moduli)
    rng = np.random.default_rng(l + len(moduli))
    qs = np.array(moduli, np.uint64).reshape(1, -1, 1)
    res = rng.integers(0, 1 << 62, size=(64, len(moduli), l), dtype=np.uint64) % qs
    got, jax_native, python, jax_python = decode_all_ways(jp, res)
    assert got is not None
    assert got == jax_native == python == jax_python


def test_native_takes_int64_residues_and_tensors_views():
    """The port's residues are int64 bit patterns: the engine reads them as
    uint64."""
    jp = make_params()
    rng = np.random.default_rng(3)
    qs = np.array(MODULI3, np.uint64).reshape(1, -1, 1)
    res = rng.integers(0, 1 << 62, size=(9, 3, 8), dtype=np.uint64) % qs
    t = u64.u64_tensor(res)
    assert tnd.decode_batch_native(t.numpy(), port(jp)) == \
        tnd.decode_batch_native(res, port(jp)) == jnd.decode_batch_native(res, jp)


def test_native_matches_jax_on_structured_inputs():
    """Noiseless encodings -(m g) mod q: the message comes back below 2^64
    and below Δ^(l-1); values from 2^64 on follow ``unwrap_or(0)``."""
    jp = make_params()
    q = jp.q_total()
    msgs = [0, 1, 42, 1000, 123456789, jp.delta_power_l_minus_1() - 1]
    res = np.stack([jp.ring.residues_from_int_coeffs([(-m * g) % q for g in jp.gadget_vector()])
                    for m in msgs]).astype(np.uint64)
    got, jax_native, python, jax_python = decode_all_ways(jp, res)
    assert got == jax_native == python == jax_python
    for m, v in zip(msgs, got):
        if m < min(jp.delta_power_l_minus_1(), 1 << 64):
            assert v == m
        elif m >= 1 << 64:
            assert v == 0


def test_native_edge_values():
    jp = make_params()
    L, l = jp.ring.num_limbs, jp.l
    rows = [np.zeros((L, l), np.uint64),
            np.array([[q - 1] * l for q in jp.ring.moduli], np.uint64)]
    rows += [np.array([[v] + [0] * (l - 1) for _ in jp.ring.moduli], np.uint64)
             for v in (1, 500, 1001)]
    got, jax_native, python, jax_python = decode_all_ways(jp, np.stack(rows))
    assert got == jax_native == python == jax_python


def test_native_deep_chain_boundaries():
    """17 x 61-bit at l = 8 has Δ ~ 2^129: outside the engine (None, as in
    the JAX package); at l = 32, Δ ~ 2^32 on a 1037-bit q: inside."""
    jp8 = make_params(moduli=generate_ntt_primes(61, 17, 8))
    res8 = np.zeros((2, 17, 8), np.uint64)
    assert not tnd.decode_supported(port(jp8))
    assert tnd.decode_batch_native(res8, port(jp8)) is None is jnd.decode_batch_native(res8, jp8)
    moduli32 = generate_ntt_primes(61, 17, 32)
    jp32 = make_params(l=32, moduli=moduli32)
    rng = np.random.default_rng(17)
    qs = np.array(moduli32, np.uint64).reshape(1, -1, 1)
    res = rng.integers(0, 1 << 62, size=(8, 17, 32), dtype=np.uint64) % qs
    got, jax_native, python, jax_python = decode_all_ways(jp32, res)
    assert got is not None
    assert got == jax_native == python == jax_python


def test_library_lands_under_build():
    """The port's library is built into the git-ignored build/, never into
    native/, which belongs to the JAX package."""
    tnd._lib()
    path = tnd.library_path()
    assert path.exists()
    assert path.resolve().relative_to((ROOT / "build").resolve())
    assert path.stat().st_mtime >= (ROOT / "native" / "pvw_decode.cpp").stat().st_mtime


def test_failed_build_raises(tmp_path, monkeypatch):
    """A compiler that fails: the build raises with its output, and a
    native decode raises too (no Python fallback)."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    fake = bindir / "g++"
    fake.write_text("#!/bin/sh\necho 'fake compiler: no such target' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(tnd, "_SO", tmp_path / "lib" / "libpvw_decode.so")
    jp = make_params()
    res = np.zeros((2, 3, 8), np.uint64)
    tnd._lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="fake compiler: no such target"):
            tnd.decode_batch_native(res, port(jp))
        with pytest.raises(RuntimeError, match="did not build"):
            tdec._decode_batch(u64.u64_tensor(res), port(jp), "native")
        assert not (tmp_path / "lib" / "libpvw_decode.so").exists()
    finally:
        tnd._lib.cache_clear()
