"""Card ms a round of the r draw (the cbd-k stream, ``ops/tfry.v3k_cbd_values``):
the elapsed time between the CUDA events of the program's
``pvw.encrypt.r_sample*`` spans, so the card's idle time inside the stage
counts. The mean over the first ``trace_requests`` rounds the program
recorded under the profiler: the pass of the card alone, which
``harness.run_cell`` makes before the pass with host operations. None where
the program records no such span or no card time (on the CPU, or a program
without spans).

That pass runs under CUPTI, which adds its cost to every launch, so a
launch-bound stage reads longer here than it runs: on an H100 at 700 W, the
r draw read 27.0 / 44.4 ms a round under it against 18.6 / 29.9 without it
(``ref128-deal`` / ``t256-deal``). A change that cuts launches reads here
as a larger gain than it makes end to end."""

from pvw_tpu_torch.utils import profiling

STAGES = ("pvw.encrypt.r_sample",)


def read(ctx):
    requests = getattr(profiling, "requests", None)
    rounds = requests("pvw.encrypt", ctx["trace"].requests) if requests else []
    ms = [[d["card_ms"] for d in r if d["name"].startswith(STAGES)] for r in rounds]
    if not ms or not all(ms) or None in sum(ms, []):
        return None
    return sum(map(sum, ms)) / len(ms)
