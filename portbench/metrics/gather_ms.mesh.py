"""Card ms a round of the mesh's transfers on rank 0: the elapsed time
between the CUDA events of the program's ``pvw.mesh.round.gather`` span (the
batched point-to-point exchange of the kdim partials' blocks, NCCL between
cards), so the card's wait for the partner's blocks counts. The mean over
the first ``trace_requests`` rounds rank 0 recorded under the profiler: the
pass of the card alone, which ``harness.run_cell`` makes before the pass
with host operations. None where the program records no such span or no
card time (on the CPU, or a program without the served mesh)."""

from pvw_tpu_torch.utils import profiling

STAGE = "pvw.mesh.round.gather"


def read(ctx):
    requests = getattr(profiling, "requests", None)
    rounds = requests("pvw.mesh.round", ctx["trace"].requests) if requests else []
    ms = [[d["card_ms"] for d in r if d["name"] == STAGE] for r in rounds]
    if not ms or not all(ms) or None in sum(ms, []):
        return None
    return sum(map(sum, ms)) / len(ms)
