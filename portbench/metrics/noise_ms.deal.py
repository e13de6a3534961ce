"""Card ms a round of the encryption noise, both products: the elapsed time
between the CUDA events of the program's ``pvw.encrypt.noise*`` spans (the
v3k generator, v3 planes, or residue noise and its NTT) and
``pvw.encrypt.addmod*`` (the residue noise's addition), so the card's idle
time inside each stage counts. The mean over the first ``trace_requests``
rounds the program recorded under the profiler: the pass of the card alone,
which ``harness.run_cell`` makes before the pass with host operations. None
where the program records no such span or no card time (on the CPU, or a
program without spans).

That pass runs under CUPTI, which adds its cost to every launch, so a
launch-bound stage reads longer here than it runs: on an H100 at 700 W,
c2's residue noise read 88.0 ms a round under it against 86.1 without it
(``ref128-deal``). A change that cuts launches reads here as a larger gain
than it makes end to end."""

from pvw_tpu_torch.utils import profiling

STAGES = ("pvw.encrypt.noise", "pvw.encrypt.addmod")


def read(ctx):
    requests = getattr(profiling, "requests", None)
    rounds = requests("pvw.encrypt", ctx["trace"].requests) if requests else []
    ms = [[d["card_ms"] for d in r if d["name"].startswith(STAGES)] for r in rounds]
    if not ms or not all(ms) or None in sum(ms, []):
        return None
    return sum(map(sum, ms)) / len(ms)
