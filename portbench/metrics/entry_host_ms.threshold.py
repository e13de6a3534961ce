"""Host ms a decryption in ``decrypt_valid_shares`` outside its stages on
the card: the self time of the program's ``pvw.decrypt`` span (its duration
less its children's) and the ``pvw.decrypt.select`` span (the checks, the
dealer indices' upload, the gather of c1 and c2). The mean over the first
``trace_requests`` decryptions the program recorded under the profiler: the
pass of the card alone, which ``harness.run_cell`` makes before the pass
with host operations. None where the program records no such span (a
program without spans)."""

from pvw_tpu_torch.utils import profiling

PARTS = ("pvw.decrypt.select",)


def read(ctx):
    requests = getattr(profiling, "requests", None)
    calls = requests("pvw.decrypt", ctx["trace"].requests) if requests else []
    if not calls:
        return None
    return sum(r[0]["self_host_ms"] + sum(d["host_ms"] for d in r if d["name"] in PARTS)
               for r in calls) / len(calls)
