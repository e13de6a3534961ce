"""The readers of the program's spans: each takes the first ``requests``
requests recorded under the profiler and their mean, and reads None
without card ms; a traced run on the CPU reads the host metrics alone."""

import json
import time

import pytest
from pb_small import REPO, small_root  # noqa: F401

from portbench import harness, spec
from portbench.trace import Trace
from pvw_tpu_torch.utils import profiling

DEAL = ["r_draw_ms.deal", "noise_ms.deal", "upload_ms.deal", "entry_host_ms.deal"]
THRESHOLD = ["contraction_ms.threshold", "decode_ms.threshold", "entry_host_ms.threshold"]
CARD = {"r_draw_ms.deal", "noise_ms.deal", "contraction_ms.threshold", "decode_ms.threshold"}


@pytest.fixture
def tracer(monkeypatch):
    fresh = profiling._Tracer()
    monkeypatch.setattr(profiling, "tracer", fresh)
    return fresh


def request(tracer, root: str, stages, scale: float, profiled=True, card=True):
    """One request: the root spans 0-100 ms x ``scale``; each stage
    (name, host ms) follows the last, or ends its predecessor as its child
    where its name extends the predecessor's; card ms twice the host's."""
    ids = tracer.ids
    t = 0.0

    def rec(name, start, end, parent):
        r = profiling._Record()
        r.name, r.id, r.parent = name, next(ids), parent
        r.start_ns, r.end_ns = int(start * 1e6), int(end * 1e6)
        r.counts, r.events, r.profiled = {}, None, profiled
        r.card_ms = 2 * (end - start) if card else None
        return r

    top = rec(root, 0, 100 * scale, None)
    top.request = top.id
    out = [top]
    for name, ms in stages:
        last = out[-1]
        if name.startswith(last.name + "."):
            r = rec(name, t - ms * scale, t, last.id)
        else:
            r = rec(name, t, t + ms * scale, top.id)
            t += ms * scale
        r.request = top.id
        out.append(r)
    tracer.records.extend(out)


ROUND = [("pvw.encrypt.checks", 1), ("pvw.encrypt.upload", 3), ("pvw.encrypt.r_sample_v3k", 5),
         ("pvw.encrypt.r_ntt_prescale_kernel", 2), ("pvw.encrypt.noise_gen_c1", 4),
         ("pvw.encrypt.kernel_c1", 10), ("pvw.encrypt.encode_table", 3),
         ("pvw.encrypt.encode_table.upload", 2),
         ("pvw.encrypt.noise_residues_c2", 20), ("pvw.encrypt.kernel_c2", 30),
         ("pvw.encrypt.addmod_c2", 6), ("pvw.encrypt.wrap", 2)]
CALL = [("pvw.decrypt.select", 2), ("pvw.decrypt.secret_key", 3),
        ("pvw.decrypt.contraction", 15), ("pvw.decrypt.decode", 70)]
# a request of scale 1: stage sums and the root's self time (100 - the
# stages); the encode table's own host ms without its copy (3 - 2)
ONE = {"r_draw_ms.deal": 2 * 5, "noise_ms.deal": 2 * (4 + 20 + 6),
       "upload_ms.deal": 3, "entry_host_ms.deal": (100 - 86) + 1 + 2 + (3 - 2),
       "contraction_ms.threshold": 2 * 15, "decode_ms.threshold": 2 * 70,
       "entry_host_ms.threshold": (100 - 90) + 2}


def read(name, requests):
    return spec.reader(name, REPO)({"trace": Trace(1.0, requests=requests)})


@pytest.mark.parametrize("name", DEAL + THRESHOLD)
def test_reader_takes_the_first_profiled_requests(tracer, name):
    root, stages = ("pvw.encrypt", ROUND) if name in DEAL else ("pvw.decrypt", CALL)
    request(tracer, root, stages, 7.0, profiled=False)      # before the profiler: skipped
    for scale in (1.0, 2.0, 5.0):
        request(tracer, root, stages, scale)
    # the first two profiled requests, scales 1 and 2: 1.5 times one request
    assert read(name, 2) == pytest.approx(1.5 * ONE[name])
    assert read(name, 3) == pytest.approx(8 / 3 * ONE[name])


@pytest.mark.parametrize("name", DEAL + THRESHOLD)
def test_reader_without_card_ms_or_spans(tracer, name):
    assert read(name, 2) is None                             # no records at all
    root, stages = ("pvw.encrypt", ROUND) if name in DEAL else ("pvw.decrypt", CALL)
    other = ("pvw.decrypt", CALL) if name in DEAL else ("pvw.encrypt", ROUND)
    request(tracer, *other, 1.0)
    assert read(name, 2) is None                             # the other path's spans
    request(tracer, root, stages, 1.0, card=False)
    if name in CARD:
        assert read(name, 2) is None
    else:
        assert read(name, 2) == pytest.approx(ONE[name])


def test_reader_of_a_program_without_spans(monkeypatch):
    monkeypatch.delattr(profiling, "requests")
    for name in DEAL + THRESHOLD:
        assert read(name, 2) is None


def test_traced_run_on_the_cpu_reads_the_host_metrics(small_root, tracer):
    cell = spec.load_cell("small-t256-deal", small_root)
    every = json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]
    cell.per_layer = [m for m in every if m["name"] in DEAL]
    res = harness.run_cell(cell, 2**33 + 41, 0.3, True, ["cpu"], time.perf_counter())
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert set(got) == {"upload_ms.deal", "entry_host_ms.deal"}
    assert got["upload_ms.deal"]["value"] > 0 and got["entry_host_ms.deal"]["value"] > 0
    assert got["upload_ms.deal"]["unit"] == "ms"
