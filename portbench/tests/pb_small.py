"""Small cells on the CPU: a copy of the benchmark's layout in a temporary
root with configurations cut to a few parties (the program runs its plain
twins there)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

SMALL = {"small-ref": ("ref128-n1024", 16, 8), "small-t256": ("t256-n1024", 8, 8)}


@pytest.fixture(scope="session")
def small_root(tmp_path_factory) -> Path:
    """A root whose BENCHMARK.json adds the cells ``small-ref-deal``,
    ``small-ref-threshold``, ``small-t256-deal`` and ``small-t256-threshold``:
    each configuration's own file with k and n cut; and ``small-ref-subset``,
    the threshold traffic with each request's dealers a count drawn from a
    range, added as a traffic file and an entry alone."""
    root = tmp_path_factory.mktemp("portbench_root")
    (root / "portbench" / "configs").mkdir(parents=True)
    for part in ("traffic", "kinds", "metrics"):
        shutil.copytree(REPO / "portbench" / part, root / "portbench" / part)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, (base, k, n) in SMALL.items():
        cfg = json.loads((REPO / "portbench" / "configs" / f"{base}.json").read_text())
        cfg.update(name=name, k=k, n=n)
        (root / "portbench" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "reduced": ["k", "n"],
                                 "file": f"portbench/configs/{name}.json", "why": "test"})
        for traffic in ("deal", "threshold"):
            bench["workloads"].append({"name": f"{name}-{traffic}", "config": name,
                                       "traffic": traffic, "chips": 1, "why": "test"})
    subset = json.loads((REPO / "portbench" / "traffic" / "threshold.json").read_text())
    subset.update(subset=[3, 6], threshold=2)
    (root / "portbench" / "traffic" / "subset.json").write_text(json.dumps(subset))
    bench["workloads"].append({"name": "small-ref-subset", "config": "small-ref",
                               "traffic": "subset", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
