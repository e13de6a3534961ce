"""The port's config leftovers against the JAX package: ``Settings.describe``
and ``reset``, the ``num_digits`` knob (``PVW_NUM_DIGITS``) read by
``RingPlan``, and the ``trace`` knob read by ``utils.profiling.span``.

A forced digit width must not change a byte: residues are canonical, so
any exact width gives the same ciphertext. At nd = 6, 7 and 8 on the
2-limb toy chain (minimal width 5) the port's ciphertext equals the JAX
package's at the same forced width and the port's own unforced bytes
(tolerance 0).
"""

import contextlib
import io
import json

import numpy as np
import jax
import pytest

import pvw_tpu as J
from pvw_tpu import config as jconfig
from pvw_tpu.config import settings as jsettings
from pvw_tpu.errors import InvalidParameters as JInvalidParameters
from pvw_tpu.params import ring as jring
import pvw_tpu_torch as P
from pvw_tpu_torch import config as tconfig, convert
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.errors import InvalidParameters
from pvw_tpu_torch.params import ring as tring
from pvw_tpu_torch.utils import profiling

MODULI = (0xFFFFEE001, 0xFFFFC4001)
MOSAIC_KNOBS = {"tile_m", "tile_n", "no_pallas", "dots_first", "vmem_limit_mb", "jax_cache_dir"}


def knobs(cls):
    return {name: attr for name, attr in vars(cls).items() if isinstance(attr, cls.__dict__[
        "noise_stream"].__class__)}


def test_describe_lists_every_knob_under_the_jax_env_vars():
    tk, jk = knobs(tconfig.Settings), knobs(jconfig.Settings)
    assert set(tsettings.describe()) == set(tk)
    assert {"num_digits", "trace"} <= set(tk)
    # every JAX knob but the Mosaic ones, under the same variable and default
    assert set(jk) - set(tk) == MOSAIC_KNOBS and set(tk) <= set(jk)
    for name, knob in tk.items():
        assert (knob.env, knob.default) == (jk[name].env, jk[name].default), name
    assert tsettings.describe()["num_digits"] is None
    assert "num_digits=None" in repr(tsettings)


def test_reset_clears_the_overrides(monkeypatch):
    monkeypatch.delenv("PVW_TPU_TRACE", raising=False)
    monkeypatch.setenv("PVW_NUM_DIGITS", "7")
    tsettings.num_digits, tsettings.trace, tsettings.noise_stream = 6, True, "v3k"
    try:
        assert tsettings.describe()["num_digits"] == 6 and tsettings.trace is True
    finally:
        tsettings.reset()
    assert tsettings.num_digits == 7                      # the env var applies again
    assert tsettings.trace is False and tsettings.noise_stream == "kernel"
    monkeypatch.setenv("PVW_TPU_TRACE", "off")
    assert tsettings.trace is False
    monkeypatch.setenv("PVW_TPU_TRACE", "1")
    assert tsettings.trace is True


@pytest.mark.parametrize("forced", ["1", "4", "9"])
def test_num_digits_validation(monkeypatch, forced):
    monkeypatch.setenv("PVW_NUM_DIGITS", forced)     # below the minimal width 5, or above 8
    with pytest.raises(InvalidParameters, match="PVW_NUM_DIGITS"):
        tring.RingPlan((0xFFFFEE001, 0xFFFFC4001), 8)
    with pytest.raises(JInvalidParameters, match="PVW_NUM_DIGITS"):
        jring.RingPlan((0xFFFFEE001, 0xFFFFC4001), 8)


def test_forced_width_builds_its_tables(monkeypatch):
    base = tring.RingPlan(MODULI, 8)
    monkeypatch.setenv("PVW_NUM_DIGITS", "7")
    forced, jforced = tring.RingPlan(MODULI, 8), jring.RingPlan(MODULI, 8)
    assert (base.num_digits, forced.num_digits, forced.num_columns) == (5, 7, 13)
    assert forced != base and hash(forced) != hash(base)
    np.testing.assert_array_equal(forced.pow_wp32, jforced.pow_wp32)
    for lt, lj in zip(forced.limbs, jforced.limbs):
        np.testing.assert_array_equal(lt.ntt_fwd_dig, lj.ntt_fwd_dig)


@contextlib.contextmanager
def forced_digits(nd):
    """Both packages' knob set and their ring memo cleared, so that the
    parameters built inside get a ring of width ``nd``."""
    jsettings.num_digits = tsettings.num_digits = nd
    jring.get_ring.cache_clear()
    tring.get_ring.cache_clear()
    try:
        yield
    finally:
        del jsettings.num_digits, tsettings.num_digits
        jring.get_ring.cache_clear()
        tring.get_ring.cache_clear()


def system(seed=0):
    """A JAX system at n = k = 8 on the toy chain, the port's copy of it,
    scalars and the encryption keys of both."""
    b1, b2 = J.PvwParameters.suggest_error_bounds(8, 8, 8, MODULI, 0.5)
    jp = (J.PvwParametersBuilder().set_parties(8).set_dimension(8).set_l(8).set_moduli(MODULI)
          .set_secret_variance(0.5).set_error_bounds(b1, b2).build())
    key = jax.random.key(seed)
    crs = J.PvwCrs.new(jp, jax.random.fold_in(key, 0))
    parties = [J.Party.new(i, jp, jax.random.fold_in(key, 100 + i)) for i in range(8)]
    jgpk = J.GlobalPublicKey(crs)
    jgpk.generate_all_party_keys(parties, jax.random.fold_in(key, 1))
    tp = convert.params_from_dict(jp.to_dict())
    tgpk = convert.global_pk_from_residues(
        jgpk.matrix.residues_np(),
        convert.crs_from_residues(crs.matrix.residues_np(), tp, device="cpu"))
    ekey = jax.random.fold_in(key, 5)
    sc = np.random.default_rng(seed).integers(0, 1 << 40, (8, 8), dtype=np.uint64)
    sk1 = convert.secret_key_from_coeffs(parties[1].secret_key.secret_coeffs, tp)
    return jp, jgpk, tp, tgpk, ekey, convert.key_from_words(
        np.asarray(jax.random.key_data(ekey))), sc, sk1


@pytest.fixture(scope="module")
def unforced():
    jp, _, tp, tgpk, _, tkey, sc, _ = system()
    assert jp.ring.num_digits == tp.ring.num_digits == 5
    out = {}
    for stream in ("kernel", "v3k"):
        tsettings.noise_stream = stream
        try:
            out[stream] = P.encrypt_batch(sc, tgpk, tkey)
        finally:
            del tsettings.noise_stream
    return out


@pytest.mark.parametrize("stream", ["kernel", "v3k"])
@pytest.mark.parametrize("nd", [6, 7, 8])
def test_forced_width_ciphertext_equals_jax_and_unforced(unforced, nd, stream):
    with forced_digits(nd):
        jp, jgpk, tp, tgpk, ekey, tkey, sc, sk1 = system()
        assert jp.ring.num_digits == tp.ring.num_digits == nd
        assert tgpk.encrypt_operands()[0].shape[-1] >= tp.k * nd
        jsettings.noise_stream = tsettings.noise_stream = stream
        try:
            tct = P.encrypt_batch(sc, tgpk, tkey)
            jct = J.encrypt_batch(sc, jgpk, ekey)
        finally:
            del jsettings.noise_stream, tsettings.noise_stream
        assert tct.params.ring.num_digits == nd
        for got, want in ((tct.c1, jct.c1), (tct.c2, jct.c2)):
            np.testing.assert_array_equal(got.residues_np(), want.residues_np())
        np.testing.assert_array_equal(tct.c1.residues_np(), unforced[stream].c1.residues_np())
        np.testing.assert_array_equal(tct.c2.residues_np(), unforced[stream].c2.residues_np())
        assert P.decrypt_party_shares(tct, sk1, 1) == [int(v) for v in sc[:, 1]]
    assert tring.get_ring(MODULI, 8).num_digits == 5


def test_span_emits_json_only_when_trace_is_on(monkeypatch):
    sink = io.StringIO()
    tracer = profiling._Tracer()
    tracer.sink = sink
    monkeypatch.setattr(profiling, "tracer", tracer)
    monkeypatch.delenv("PVW_TPU_TRACE", raising=False)
    with profiling.span("quiet", n=1):
        pass
    assert profiling.flush() == 0 and sink.getvalue() == "" and profiling.read() == []
    monkeypatch.setenv("PVW_TPU_TRACE", "1")
    with profiling.span("encrypt", dealers=8):
        pass
    assert sink.getvalue() == ""                    # kept in memory until flush()
    assert profiling.flush() == 1
    line = json.loads(sink.getvalue())
    assert line["span"] == "encrypt" and line["dealers"] == 8 and line["ms"] >= 0
    assert line["request"] == line["id"] and line["parent"] is None
    assert [d["name"] for d in profiling.read()] == ["encrypt"]
    profiling.clear()
    assert profiling.read() == [] and profiling.flush() == 0
    tsettings.trace = False                         # programmatic beats the env var
    try:
        with profiling.span("after"):
            pass
        assert profiling.read() == []
    finally:
        del tsettings.trace
    with profiling.span("enabled"):
        pass
    assert profiling.flush() == 1
    assert json.loads(sink.getvalue().splitlines()[-1])["span"] == "enabled"


def test_trace_to_and_device_summary(tmp_path):
    import torch

    with profiling.trace_to(str(tmp_path)) as prof:
        torch.ones(8).cumsum(0)
    assert prof is not None and (tmp_path / "trace.json").stat().st_size > 0
