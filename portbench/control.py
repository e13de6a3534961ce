"""The control of ``correct``: the plain reference put in the program's
place, computed below the precision the configuration states, judged by
the same comparison as a run. A deal cell's control encodes the scalars
at 32 bits (their high words dropped); a threshold cell's decodes from
the top gadget coefficient alone (no sequential rounding). Each seed
gives the program's reading (a sound run: the lower reading) and the
control's (the upper reading) of every compared number.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--requests N]

It runs at the cell's own size on the card (the benchmark's runs never
run it); ``control_readings`` is what the tests call at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def control_readings(cell, seed: int, requests: int, device) -> dict:
    """The sound and the control readings of one seed: ``requests`` requests
    of the cell's traffic through the program, then both judged."""
    from . import spec
    from .reference.pvw import Scheme

    mix = spec.kind(cell.traffic, cell.root)(cell, seed, [device])
    mix.warm()
    mix.run_count(requests)
    scheme = Scheme(cell.config, device)
    out = mix.collect()
    ctrl = mix.control(out, scheme)
    mix.free()
    return {"seed": seed, "failed": mix.failed,
            "sound": {k: v for k, (v, _) in mix.judge(out, scheme).items()},
            "control": {k: v for k, (v, _) in mix.judge(ctrl, scheme).items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--requests", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    rows = []
    for s in args.seeds.split(","):
        t = time.perf_counter()
        row = control_readings(cell, int(s), args.requests, "cuda:0")
        row["seconds"] = time.perf_counter() - t
        rows.append(row)
        print(json.dumps(row), flush=True)
    keys = rows[0]["sound"]
    print(json.dumps({"workload": cell.name, "seeds": len(rows),
                      "lower": {k: max(r["sound"][k] for r in rows) for k in keys},
                      "upper": {k: min(r["control"][k] for r in rows) for k in keys}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
