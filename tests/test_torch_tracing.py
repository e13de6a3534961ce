"""The port's spans (``pvw_tpu_torch.utils.profiling``): nesting and self
times, when a span records (``settings.trace`` read live, or a running
``torch.profiler``), the stages that an encryption and a threshold
decryption record, and the JSON lines ``PVW_TPU_TRACE=1`` writes at
``flush()``."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pvw_tpu_torch as P
from pvw_tpu_torch import random as R
from pvw_tpu_torch.config import settings
from pvw_tpu_torch.utils import profiling

MODULI = (0xFFFFC4001, 0x1FFFFE0001)
N, K, ELL = 3, 8, 8


@pytest.fixture
def tracer(monkeypatch):
    """A fresh tracer, tracing off whatever the environment says."""
    fresh = profiling._Tracer()
    monkeypatch.setattr(profiling, "tracer", fresh)
    monkeypatch.delenv("PVW_TPU_TRACE", raising=False)
    settings.trace = False
    yield fresh
    del settings.trace


@pytest.fixture(scope="module")
def toy():
    b1, b2 = P.PvwParameters.suggest_error_bounds(N, K, ELL, MODULI, 0.5)
    params = (P.PvwParametersBuilder().set_parties(N).set_dimension(K).set_l(ELL)
              .set_moduli(MODULI).set_secret_variance(0.5).set_error_bounds_u32(b1, b2)
              .build())
    key = R.key(5)
    gpk = P.GlobalPublicKey(P.PvwCrs.new(params, R.fold_in(key, 1), device="cpu"))
    parties = [P.Party.new(i, params, R.fold_in(key, 100 + i), device="cpu")
               for i in range(N)]
    gpk.generate_all_party_keys(parties, R.fold_in(key, 2))
    shares = np.arange(N * N, dtype=np.uint64).reshape(N, N) * np.uint64(977) + np.uint64(5)
    return gpk, parties, shares, R.fold_in(key, 3)


class _Clock:
    """perf_counter_ns stepping by a millisecond a reading."""

    def __init__(self):
        self.ns = 0

    def perf_counter_ns(self):
        self.ns += 1_000_000
        return self.ns


def test_nesting_ids_requests_and_self_time(tracer, monkeypatch):
    monkeypatch.setattr(profiling, "time", _Clock())
    settings.trace = True
    with profiling.span("root", dealers=4):            # reads 1 ms ... 8 ms
        with profiling.span("root.a"):                  # 2 ... 3
            pass
        with profiling.span("root.b", bytes=64):        # 4 ... 7
            with profiling.span("root.b.c"):            # 5 ... 6
                pass
    with profiling.span("second"):
        pass
    recs = {d["name"]: d for d in profiling.read()}
    assert [d["name"] for d in profiling.read()] == ["root", "root.a", "root.b", "root.b.c",
                                                     "second"]
    root, a, b, c = recs["root"], recs["root.a"], recs["root.b"], recs["root.b.c"]
    assert root["parent"] is None and a["parent"] == b["parent"] == root["id"]
    assert c["parent"] == b["id"]
    assert {d["request"] for d in (root, a, b, c)} == {root["id"]}
    assert recs["second"]["request"] == recs["second"]["id"] != root["id"]
    assert (root["host_ms"], a["host_ms"], b["host_ms"], c["host_ms"]) == (7, 1, 3, 1)
    # self time: the duration less the part the children cover
    assert root["self_host_ms"] == 7 - 1 - 3 and b["self_host_ms"] == 3 - 1
    assert a["self_host_ms"] == a["host_ms"]
    assert root["counts"] == {"dealers": 4} and b["counts"] == {"bytes": 64}
    assert root["card_ms"] is None and root["self_card_ms"] is None   # no card here
    assert [[d["name"] for d in r] for r in profiling.requests("root", profiled=False)] == [
        ["root", "root.a", "root.b", "root.b.c"]]
    assert profiling.requests("root") == []           # none recorded under a profiler


def test_off_records_nothing_and_opens_no_range(tracer, monkeypatch):
    opened = []
    monkeypatch.setattr(torch.profiler, "record_function", lambda name: opened.append(name))
    with profiling.span("pvw.encrypt", dealers=1):
        pass
    assert profiling.read() == [] and opened == []


def test_trace_knob_is_read_at_each_span(tracer, monkeypatch):
    with profiling.span("before"):
        pass
    settings.trace = True                  # after import: on from the next span
    with profiling.span("on"):
        pass
    del settings.trace
    monkeypatch.setenv("PVW_TPU_TRACE", "1")
    with profiling.span("env"):
        pass
    monkeypatch.setenv("PVW_TPU_TRACE", "0")
    with profiling.span("env off"):
        pass
    assert [(d["name"], d["profiled"]) for d in profiling.read()] == [
        ("on", False), ("env", False)]


def test_running_profiler_records_and_opens_the_range(tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("pvw.encrypt"):
            with profiling.span("pvw.encrypt.upload"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert "pvw.encrypt" in names and "pvw.encrypt.upload" in names
    assert [(d["name"], d["profiled"]) for d in profiling.read()] == [
        ("pvw.encrypt", True), ("pvw.encrypt.upload", True)]
    assert [len(r) for r in profiling.requests("pvw.encrypt", 1)] == [2]
    with profiling.span("after"):          # the profiler has stopped
        pass
    assert len(profiling.read()) == 2


def test_request_paths_record_their_stages_in_order(tracer, toy):
    gpk, parties, shares, key = toy
    settings.trace = True
    settings.decode_mode = "device"
    try:
        ct = P.encrypt_all_party_shares_batched(shares, gpk, key)
        got = P.decrypt_valid_shares(ct, [0, 2], 2, parties[1].secret_key, 1)
    finally:
        del settings.decode_mode
    assert got == [(0, int(shares[0, 1])), (2, int(shares[2, 1]))]
    enc, = profiling.requests("pvw.encrypt", profiled=False)
    assert [d["name"] for d in enc] == [f"pvw.encrypt{s}" for s in (
        "", ".checks", ".upload", ".r_sample", ".r_ntt_prescale_kernel", ".noise_c1",
        ".kernel_c1", ".encode_table", ".encode_table.upload", ".noise_c2", ".kernel_c2",
        ".wrap")]
    table, copy = enc[7], enc[8]
    assert copy["parent"] == table["id"] and table["parent"] == enc[0]["id"]
    assert enc[2]["counts"] == {"dealers": N, "bytes": N * N * 8}
    dec, = profiling.requests("pvw.decrypt", profiled=False)
    assert [d["name"] for d in dec] == ["pvw.decrypt", "pvw.decrypt.select",
                                        "pvw.decrypt.secret_key", "pvw.decrypt.contraction",
                                        "pvw.decrypt.decode"]
    assert dec[0]["counts"] == {"valid": 2} and dec[-1]["counts"] == {"engine": "device"}
    for req in (enc, dec):
        root = req[0]
        kids = [d for d in req if d["parent"] == root["id"]]
        assert root["self_host_ms"] == pytest.approx(
            root["host_ms"] - sum(d["host_ms"] for d in kids), abs=1e-6)


def test_trace_env_writes_at_flush_only(tracer, monkeypatch, capsys, toy):
    gpk, parties, shares, key = toy
    monkeypatch.setenv("PVW_TPU_TRACE", "1")
    del settings.trace
    P.encrypt_all_party_shares_batched(shares, gpk, key)
    assert capsys.readouterr().err == ""
    assert profiling.flush() == 12
    lines = [json.loads(s) for s in capsys.readouterr().err.splitlines()]
    assert len(lines) == 12 and lines[0]["span"] == "pvw.encrypt" and lines[0]["ms"] > 0
    assert lines[2]["span"] == "pvw.encrypt.upload" and lines[2]["dealers"] == N
    assert {ln["request"] for ln in lines} == {lines[0]["id"]}
    assert profiling.flush() == 0 and capsys.readouterr().err == ""
