"""Observability: timing spans and profiler capture, the counterpart of
``pvw_tpu.utils.profiling``.

- :func:`span`: nestable wall-clock spans with JSON-able records, on when
  ``settings.trace`` (``PVW_TPU_TRACE=1``) is set when this module is first
  imported, or after :meth:`_Tracer.enable`; no-ops otherwise;
- :func:`trace_to`: ``torch.profiler`` over a region (CPU and, where a card
  is visible, CUDA activity), written as a Chrome trace;
- :func:`device_summary`: a one-line fingerprint of the devices.

A span measures the host clock: work queued on a card ends inside it only
if the region synchronizes. ``enable_compilation_cache`` (JAX's persistent
compilation cache) has no counterpart: the kernels are built once into
``build/kernels`` and reused by hash.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time
from dataclasses import dataclass


@dataclass
class SpanRecord:
    name: str
    start: float
    elapsed_s: float
    meta: dict


class _Tracer:
    def __init__(self) -> None:
        from ..config import settings

        self.enabled = settings.trace
        self.records: list[SpanRecord] = []
        self.sink = sys.stderr

    def enable(self, sink=None) -> None:
        self.enabled = True
        if sink is not None:
            self.sink = sink

    def disable(self) -> None:
        self.enabled = False

    def emit(self, rec: SpanRecord) -> None:
        self.records.append(rec)
        print(json.dumps({"span": rec.name, "ms": round(rec.elapsed_s * 1000, 3), **rec.meta}),
              file=self.sink, flush=True)

    def clear(self) -> list[SpanRecord]:
        out, self.records = self.records, []
        return out


tracer = _Tracer()


@contextlib.contextmanager
def span(name: str, **meta):
    """Wall-clock span; records and emits one JSON line when tracing is on."""
    if not tracer.enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        tracer.emit(SpanRecord(name, t0, time.perf_counter() - t0, meta))


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the enclosed region with ``torch.profiler`` (CPU, and CUDA
    when a card is visible) and write it to ``logdir/trace.json`` (Chrome
    trace format). Yields the profiler."""
    import torch
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


def device_summary() -> str:
    """The visible CUDA devices by name and count ("1x NVIDIA H100 80GB
    HBM3"), or "cpu" when there is none."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
        return "cpu"
    kinds: dict = {}
    for i in range(torch.cuda.device_count()):
        name = torch.cuda.get_device_name(i)
        kinds[name] = kinds.get(name, 0) + 1
    return ", ".join(f"{v}x {k}" for k, v in kinds.items())
