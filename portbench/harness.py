"""One run of one cell: set-up, the measured (or traced) window, the
metrics, and the comparison with the plain reference that decides
``correct``.

``python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``
prints one JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its limit,
which also close standard error. It exits non-zero and prints no result
without enough CUDA cards, or when the JAX package or JAX is loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "pvw_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card_info() -> dict:
    """The card's power limit and SM clocks, as nvidia-smi reads them."""
    q = "power.limit,clocks.sm,clocks.max.sm"
    try:
        row = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    first = row.strip().splitlines()[0].split(", ") if row.strip() else []
    return dict(zip(("power_limit", "clock_sm", "clock_max_sm"), first))


def quantiles_ms(latencies) -> dict:
    """Some quantiles of the window's latencies, for the log."""
    lat = sorted(latencies) or [0.0]
    return {f"q{q}": lat[min(len(lat) - 1, len(lat) * q // 100)] * 1e3
            for q in (0, 5, 25, 50, 75, 90, 95, 99, 100)}


def run_cell(cell, seed: int, seconds: float, trace: bool, devices, t0: float) -> dict:
    """One run of ``cell`` on ``devices``, one a chip the cell asks for (the
    CPU only in tests); ``t0``: the process's start on the host clock."""
    import torch

    from . import spec
    from .reference.pvw import Scheme
    from .system import sync

    devices = [torch.device(d) for d in devices]
    mix = spec.kind(cell.traffic, cell.root)(cell, seed, devices)
    mix.warm()
    for d in devices:
        sync(d)
    # set-up's objects live for the run: keep the window's collections to its own
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t0
    result: dict = {"metrics": {}}
    if trace:
        from .trace import NAMED_REQUESTS, capture

        # the traced requests run once untraced first: the host clock over
        # them is the window of the idle share, which the profiler's own
        # work in a traced window would lengthen
        count, first = int(cell.traffic["trace_requests"]), mix.next
        t = time.perf_counter()
        mix.run_count(count)
        for d in devices:
            sync(d)
        untraced_s = time.perf_counter() - t
        tr = capture(lambda: mix.run_count(count, first), count)
        named = capture(lambda: mix.run_count(NAMED_REQUESTS), NAMED_REQUESTS, host_ops=True)
        ctx = {"trace": tr, "untraced_s": untraced_s, "config": cell.config,
               "traffic": cell.traffic}
        for m in cell.per_layer:
            value = spec.reader(m["name"], cell.root)(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": named.idle_gaps()}
        traced = {"busy_s": tr.busy_us / 1e6, "window_s": tr.window_us / 1e6}
    else:
        window_s = mix.run_for(seconds)
        print("latency_ms", json.dumps(quantiles_ms(mix.latencies)), file=sys.stderr)
        values = {**mix.end_to_end(window_s), "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
        traced = {}
    cuda = devices[0].type == "cuda"
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(devices[0]) if cuda else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in devices)
        if cuda else 0,
        **traced, **(card_info() if cuda else {})}
    gc.unfreeze()
    out = mix.collect()
    mix.free()
    checks = mix.judge(out, Scheme(cell.config, devices[0]))
    ok = (mix.attempted > 0 and mix.failed == 0
          and all(lim is None or v <= lim for v, lim in checks.values()))
    result["correct"] = ok
    result["attempted"], result["failed"] = mix.attempted, mix.failed
    if mix.failed:
        result["error"] = mix.error
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return result


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one host thread for torch's own CPU ops: the caller's thread drives the
    # card, and idle pool threads would only contend with it for the host
    torch.set_num_threads(1)
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   [f"cuda:{i}" for i in range(cell.chips)], t0)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in the run's process: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = {k: res[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    for k in ("breakdown", "error"):
        if k in res:
            line[k] = res[k]
    line["checks"] = res["checks"]
    for k, c in res["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(line))
    return 0
