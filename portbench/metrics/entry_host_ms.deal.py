"""Host ms a round in ``encrypt_batch`` outside its device stages: the self
time of the program's ``pvw.encrypt`` span (its duration less its
children's), the ``pvw.encrypt.checks`` and ``.wrap`` spans, and the self
time of ``.encode_table`` (the table's host work: its copy, the span
``.encode_table.upload``, is left out, since the host waits there for c1's
product on the card). The mean over the first ``trace_requests`` rounds the
program recorded under the profiler: the pass of the card alone, which
``harness.run_cell`` makes before the pass with host operations. None where
the program records no such span (a program without spans)."""

from pvw_tpu_torch.utils import profiling

PARTS = ("pvw.encrypt.checks", "pvw.encrypt.wrap")
TABLE = "pvw.encrypt.encode_table"


def read(ctx):
    requests = getattr(profiling, "requests", None)
    rounds = requests("pvw.encrypt", ctx["trace"].requests) if requests else []
    if not rounds:
        return None
    return sum(r[0]["self_host_ms"]
               + sum(d["host_ms"] for d in r if d["name"] in PARTS)
               + sum(d["self_host_ms"] for d in r if d["name"] == TABLE)
               for r in rounds) / len(rounds)
