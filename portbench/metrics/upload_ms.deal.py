"""Host ms a round of the scalars' upload: the program's
``pvw.encrypt.upload`` span (the host copy of the n x n u64 scalars and the
pageable host-to-device copy, which returns once the card has them). The
mean over the first ``trace_requests`` rounds the program recorded under
the profiler: the pass of the card alone, which ``harness.run_cell`` makes
before the pass with host operations. None where the program records no
such span (a program without spans)."""

from pvw_tpu_torch.utils import profiling

STAGE = "pvw.encrypt.upload"


def read(ctx):
    requests = getattr(profiling, "requests", None)
    rounds = requests("pvw.encrypt", ctx["trace"].requests) if requests else []
    ms = [[d["host_ms"] for d in r if d["name"] == STAGE] for r in rounds]
    if not ms or not all(ms):
        return None
    return sum(map(sum, ms)) / len(ms)
