"""The traced window, in two passes of ``torch.profiler``.

The first records the card's activity alone over ``trace_requests``
requests: its device intervals give their union (the busy time:
overlapping operations count once) and the device operations with the
most time; the host clock around it gives the traced window. The idle
share divides the busy time by the host clock over the same requests made
untraced (``harness.run_cell``): CUPTI's cost a launch still lengthens
the traced window of launch-bound requests. The second pass records host
operations too, over two more requests, inside a window span, and names
each of its longest idle gaps by the host operation running in it:
recording every host operation slows the host, so those gaps are longer
than an untraced request's.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

WINDOW_SPAN = "portbench.window"
NAMED_REQUESTS = 2


def union_us(intervals) -> list[tuple[float, float]]:
    """Merge (start, end) intervals into disjoint ones, in order."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


def gaps(merged, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi] between disjoint busy intervals."""
    out, t = [], lo
    for s, e in merged:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


@dataclass
class Trace:
    window_us: float                            # the traced requests' wall time
    device: list = field(default_factory=list)  # (name, start_us, end_us)
    host: list = field(default_factory=list)    # (name, start_us, end_us), host ops
    requests: int = 0
    window: tuple | None = None                 # the window span's bounds, us

    def busy_intervals(self):
        spans = [(s, e) for _, s, e in self.device]
        return union_us(clip(spans, *self.window) if self.window else spans)

    @property
    def busy_us(self) -> float:
        return sum(e - s for s, e in self.busy_intervals())

    def kernel_us(self, fragment: str) -> float:
        """Summed device time of the operations whose name holds ``fragment``."""
        return sum(e - s for n, s, e in self.device if fragment in n)

    def top_ops(self, count: int = 10) -> list[list]:
        tot: dict[str, float] = {}
        for n, s, e in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n[:120], t / 1e6] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:count]]

    def idle_gaps(self, count: int = 10) -> list[list]:
        """The longest idle gaps of the window span, each named by the
        innermost host operation that spans its middle ("host idle" where
        none does)."""
        out = []
        for s, e in sorted(gaps(self.busy_intervals(), *self.window),
                           key=lambda g: g[0] - g[1])[:count]:
            mid = (s + e) / 2
            cover = [h for h in self.host if h[1] <= mid <= h[2]]
            name = max(cover, key=lambda h: h[1])[0] if cover else "host idle"
            out.append([name[:120], (e - s) / 1e6])
        return out


def capture(run, requests: int, host_ops: bool = False) -> Trace:
    """``run()`` under the profiler; ``requests``: how many requests it
    makes. Card activity alone, the window by the host clock; with
    ``host_ops``, host operations too, the window the span around ``run``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = ([ProfilerActivity.CPU] if host_ops or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            run()
            sync()
            wall_us = (time.perf_counter() - t0) * 1e6
    window, device, host = None, [], []
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        on_card = ev.device_type == DeviceType.CUDA
        if ev.name == WINDOW_SPAN:
            if not on_card:
                window = rng
        elif on_card:
            # ranges of record_function drawn on the card's timeline are no work
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith("Activity Buffer")):
                device.append((ev.name, *rng))
        elif not ev.name.startswith("Activity Buffer"):     # the profiler's own
            host.append((ev.name, *rng))
    if not host_ops:
        return Trace(wall_us, device, [], requests)
    if window is None:
        raise RuntimeError("the profiler recorded no window span")
    return Trace(window[1] - window[0], device, host, requests, window)
