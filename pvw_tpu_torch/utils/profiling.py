"""Observability: spans at each stage of a request, and profiler capture;
the counterpart of ``pvw_tpu.utils.profiling``.

- :func:`span`: a nestable span, recorded while ``settings.trace``
  (``PVW_TPU_TRACE=1``) is on or a ``torch.profiler`` session runs, a no-op
  otherwise. A record holds the name, its id, its parent's, the request's
  (the outermost span's id), the host clock at entry and exit
  (``perf_counter_ns``), the counts passed, and, where the process has
  touched a CUDA card, two CUDA events recorded on the current stream at
  entry and exit (resolved only when the records are read: no
  synchronize). Under a running profiler a span is also a
  ``record_function`` range, on the profiler's own clock.
- :func:`read`: the records kept (the newest :data:`RECORDS`) as dicts,
  with each one's card ms and self times; :func:`requests`: them grouped by
  request; :func:`flush`: one JSON line a record to stderr under
  ``settings.trace`` (also at exit); :func:`clear`.
- :func:`trace_to`: ``torch.profiler`` over a region (CPU and, where a card
  is visible, CUDA activity), written as a Chrome trace: the operator's
  exporter, every ``pvw.`` span drawn over the card's lanes.

A span's card ms is the elapsed time between its events on the stream: its
stretch of the card's timeline, the idle time in which the card waits for
its launches included. ``enable_compilation_cache`` (JAX's persistent
compilation cache) has no counterpart: the kernels are built once into
``build/kernels`` and reused by hash.
"""

from __future__ import annotations

import atexit
import contextlib
import contextvars
import itertools
import json
import os
import sys
import time
from collections import deque

import torch
import torch.autograd.profiler as _autograd_profiler

from ..config import settings

#: Records kept, the newest.
RECORDS = 1 << 16

_current: contextvars.ContextVar = contextvars.ContextVar("pvw_span", default=None)
_OFF = contextlib.nullcontext()


class _Record:
    __slots__ = ("name", "id", "parent", "request", "start_ns", "end_ns", "counts",
                 "events", "card_ms", "profiled")


class _Tracer:
    """The records of one process, the newest ``maxlen`` kept."""

    def __init__(self, maxlen: int = RECORDS) -> None:
        self.records: deque = deque(maxlen=maxlen)
        self.ids = itertools.count(1)
        self.written = 0            # the last id flush() wrote
        self.sink = None            # None: sys.stderr when writing
        self.flush_at_exit = False

    def clear(self) -> None:
        self.records.clear()

    def read(self) -> list[dict]:
        recs = sorted(self.records, key=lambda r: r.id)
        kids: dict = {}
        for r in recs:
            if r.parent is not None:
                kids.setdefault(r.parent, []).append(r)
        out = []
        for r in recs:
            card = _card_ms(r)
            own = kids.get(r.id, [])
            # children run one after another, inside their parent
            covered = sum(c.end_ns - c.start_ns for c in own)
            kid_card = [_card_ms(c) for c in own]
            out.append({
                "name": r.name, "id": r.id, "parent": r.parent, "request": r.request,
                "start_ns": r.start_ns, "end_ns": r.end_ns,
                "host_ms": (r.end_ns - r.start_ns) / 1e6,
                "self_host_ms": (r.end_ns - r.start_ns - covered) / 1e6,
                "card_ms": card,
                "self_card_ms": None if card is None or None in kid_card
                else card - sum(kid_card),
                "counts": dict(r.counts), "profiled": r.profiled})
        return out

    def flush(self) -> int:
        """Under ``settings.trace``, one JSON line to the sink for each
        record not written yet; the lines written."""
        if not settings.trace:
            return 0
        new = [d for d in self.read() if d["id"] > self.written]
        sink = self.sink or sys.stderr
        for d in new:
            print(json.dumps({"span": d["name"], "ms": d["host_ms"], **d["counts"],
                              "self_ms": d["self_host_ms"], "card_ms": d["card_ms"],
                              "self_card_ms": d["self_card_ms"], "id": d["id"],
                              "parent": d["parent"], "request": d["request"],
                              "start_ns": d["start_ns"]}), file=sink)
        if new:
            self.written = new[-1]["id"]
            sink.flush()
        return len(new)


def _card_ms(r: _Record):
    """The card ms between a record's events, resolved once (waits for the
    end event), or None without events."""
    if r.events is not None:
        start, end = r.events
        end.synchronize()
        r.card_ms, r.events = start.elapsed_time(end), None
    return r.card_ms


tracer = _Tracer()


class _Span:
    __slots__ = ("rec", "token", "range")

    def __init__(self, name: str, counts: dict, profiled: bool) -> None:
        rec = self.rec = _Record()
        rec.name, rec.counts, rec.profiled = name, counts, profiled
        rec.events = rec.card_ms = None
        self.range = torch.profiler.record_function(name) if profiled else None

    def __enter__(self):
        rec = self.rec
        parent = _current.get()
        rec.id = next(tracer.ids)
        rec.parent = None if parent is None else parent.id
        rec.request = rec.id if parent is None else parent.request
        if self.range is not None:
            self.range.__enter__()
        if torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        self.token = _current.set(rec)
        rec.start_ns = time.perf_counter_ns()

    def __exit__(self, *exc) -> bool:
        rec = self.rec
        rec.end_ns = time.perf_counter_ns()
        _current.reset(self.token)
        if rec.events is not None:
            rec.events[1].record()
        if self.range is not None:
            self.range.__exit__(*exc)
        tracer.records.append(rec)
        return False


def span(name: str, **counts):
    """A span named ``name`` with ``counts`` (dealers, bytes, an engine's
    name), recorded when a ``torch.profiler`` session runs or
    ``settings.trace`` is on (read at each span); otherwise a flag check
    and nothing else."""
    # torch's own Python flag of a running profiler: the cheapest check
    profiled = _autograd_profiler._is_profiler_enabled
    if not (profiled or settings.trace):
        return _OFF
    if not profiled and not tracer.flush_at_exit:
        tracer.flush_at_exit = True
        atexit.register(flush)
    return _Span(name, counts, profiled)


def read() -> list[dict]:
    """Every record kept, oldest first, as dicts: ``name``, ``id``,
    ``parent``, ``request``, ``start_ns``/``end_ns`` (``perf_counter_ns``),
    ``host_ms``, ``self_host_ms`` (less the part its children cover),
    ``card_ms`` and ``self_card_ms`` (less its children's card ms; None
    without CUDA events), ``counts``, ``profiled`` (recorded under a
    running profiler)."""
    return tracer.read()


def requests(root: str, first: int | None = None, profiled: bool = True) -> list[list[dict]]:
    """The records of each request whose outermost span is named ``root``,
    oldest first, the first ``first`` of them; with ``profiled``, only the
    requests recorded under a running profiler."""
    recs = read()
    roots = [d["id"] for d in recs if d["parent"] is None and d["name"] == root
             and (d["profiled"] or not profiled)][:first]
    spans: dict = {i: [] for i in roots}
    for d in recs:
        if d["request"] in spans:
            spans[d["request"]].append(d)
    return [spans[i] for i in roots]


def flush() -> int:
    """Write the records not written yet, one JSON line each, to stderr,
    when ``settings.trace`` is on; the lines written."""
    return tracer.flush()


def clear() -> None:
    """Drop every record kept."""
    tracer.clear()


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` (CPU, and CUDA
    when a card is visible) and write it to ``logdir/trace.json`` (Chrome
    trace format), each ``pvw.`` span a range on the host and over the
    card's lanes. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
