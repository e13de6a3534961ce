"""The link's share on rank 0: the bytes rank 0 receives a round (the
``bytes_in`` count of the program's ``pvw.mesh.round.gather`` span) over
the device time of the NCCL kernels a round (the operations whose name
holds "nccl", from the profile of the card alone), as a share of NVLink's
450 GB/s a direction (NVIDIA H100 SXM data sheet: 900 GB/s both ways). An
NCCL kernel starts when rank 0 posts its transfers and may wait there for
its partner's, so a partner that finishes later reads as a lower share.
The means over the first ``trace_requests`` rounds rank 0 recorded under
the profiler. None where the program records no such span or the profile
no NCCL kernel (on the CPU, gloo's host transport, or a program without
the served mesh)."""

from pvw_tpu_torch.utils import profiling

STAGE = "pvw.mesh.round.gather"
NVLINK_BYTES_PER_S = 450e9


def read(ctx):
    t = ctx["trace"]
    requests = getattr(profiling, "requests", None)
    rounds = requests("pvw.mesh.round", t.requests) if requests else []
    got = [d["counts"].get("bytes_in") for r in rounds for d in r if d["name"] == STAGE]
    nccl_us = sum(e - s for n, s, e in t.device if "nccl" in n.lower())
    if not got or None in got or not nccl_us:
        return None
    return 100 * sum(got) / len(rounds) / (nccl_us / 1e6 / t.requests) / NVLINK_BYTES_PER_S
