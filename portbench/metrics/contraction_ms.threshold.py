"""Card ms a decryption of the contraction (``_noisy_messages``: the float64
digit contraction over k, the subtraction of c2, the inverse NTT): the
elapsed time between the CUDA events of the program's
``pvw.decrypt.contraction`` span, so the card's idle time inside the stage
counts. The mean over the first ``trace_requests`` decryptions the program
recorded under the profiler: the pass of the card alone, which
``harness.run_cell`` makes before the pass with host operations. None where
the program records no such span or no card time (on the CPU, or a program
without spans).

That pass runs under CUPTI, which adds its cost to every launch, so a
launch-bound stage reads longer here than it runs: on an H100 at 700 W, the
contraction read 61.2 / 16.7 ms under it against 59.9 / 16.1 without it
(``t256-threshold`` / ``ref128-threshold``). A change that cuts launches
reads here as a larger gain than it makes end to end."""

from pvw_tpu_torch.utils import profiling

STAGE = "pvw.decrypt.contraction"


def read(ctx):
    requests = getattr(profiling, "requests", None)
    calls = requests("pvw.decrypt", ctx["trace"].requests) if requests else []
    ms = [[d["card_ms"] for d in r if d["name"] == STAGE] for r in calls]
    if not ms or not all(ms) or None in sum(ms, []):
        return None
    return sum(map(sum, ms)) / len(ms)
