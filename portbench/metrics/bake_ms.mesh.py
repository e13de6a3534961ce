"""Card ms a round of the bake route on rank 0: the elapsed time between
the CUDA events of the program's ``pvw.mesh.round.bake`` span (c2's residue
noise, ``csrc/residue_noise.cu``, and the gadget encode, added mod q into
the shard's block of rows in plain torch before the transfers). The mean
over the first ``trace_requests`` rounds rank 0 recorded under the
profiler: the pass of the card alone, which ``harness.run_cell`` makes
before the pass with host operations. None where the program records no
such span or no card time (on the CPU, a program without the served mesh,
or a bound whose noise the masked form draws)."""

from pvw_tpu_torch.utils import profiling

STAGE = "pvw.mesh.round.bake"


def read(ctx):
    requests = getattr(profiling, "requests", None)
    rounds = requests("pvw.mesh.round", ctx["trace"].requests) if requests else []
    ms = [[d["card_ms"] for d in r if d["name"] == STAGE] for r in rounds]
    if not ms or not all(ms) or None in sum(ms, []):
        return None
    return sum(map(sum, ms)) / len(ms)
