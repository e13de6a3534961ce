#!/usr/bin/env python3
"""Look inside the v3k noise generator on the card: its instruction mix and
its instruction rate.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 probes/v3k_generator.py

Builds ``pvw_tpu_torch/csrc/v3k_noise_planes.cu`` as the port does, lists
the SASS of its jr = 1 kernel with ``cuobjdump -sass`` (an opcode
histogram: every Threefry round is unrolled and a thread's row loop runs
once at these shapes, so the static count is what each thread executes for
its two values), then times the generator at the toy chain's c2 shape (4096
x 4096 x l = 8) and config 4's (1024 x 1024 x l = 16): CUDA events, median
of 10. From the two it gives the instructions issued a second, beside the
SMs' issue ceiling (132 x 128 lanes x 1.98 GHz) and the INT32 lanes' rate
(132 x 64 x 1.98 GHz). One JSON line per result.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

INT32_LANE_OPS_PER_S = 132 * 64 * 1.98e9


def sass_histogram(lib: Path) -> dict:
    """Opcode counts of the jr = 1 kernel in the built library."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run([str(Path(CUDA_HOME) / "bin" / "cuobjdump"), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    hist, inside = collections.Counter(), False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "v3k_noise_planes_kernelILi1E" in line
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if inside and m:
            hist[m.group(1)] += 1
    return dict(hist.most_common())


def main() -> int:
    import torch

    from pvw_tpu_torch.ops import _build, fused_modmat as fm

    if not torch.cuda.is_available():
        print("v3k_generator: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    card = cs.card_line()
    _build.build_all([fm.NOISE_KERNEL])
    hist = sass_histogram(_build.target(fm.NOISE_KERNEL))
    per_thread = sum(hist.values())
    cs.emit({"probe": "sass", "kernel": fm.NOISE_KERNEL, "jr": 1,
             "instructions_per_thread": per_thread,
             "instructions_per_value": per_thread / 2, "opcodes": hist})
    dev = torch.device("cuda")
    for name, rows, cols, l in (("toy c2", cs.N_RECEIVERS, cs.N_RECEIVERS, cs.ELL),
                                ("config-4 c2", cs.DEEP_N, cs.DEEP_N, cs.DEEP_ELL)):
        ms = cs.cuda_ms(lambda: fm.v3k_noise_planes(*cs.V3K_KEY, 0, rows, cols, l, 50, 0,
                                                    dev), reps=10)
        values = rows * cols * l
        rate = per_thread * values / 2 / (ms / 1e3)
        cs.emit({"probe": "rate", "shape": f"{name} rows={rows} cols={cols} l={l} jr=1",
                 "card": card, "ms": ms, "values": values,
                 "instructions_per_s": rate,
                 "share_of_issue_ceiling": rate / cs.INT32_OPS_PER_S,
                 "share_of_int32_lanes": rate / INT32_LANE_OPS_PER_S})
    return 0


if __name__ == "__main__":
    sys.exit(main())
