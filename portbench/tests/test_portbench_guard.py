"""No JAX and no JAX package in the run's process; the reference imports
nothing of the program."""

import ast
import subprocess
import sys

from pb_small import REPO

from portbench.harness import forbidden_modules


def test_top_level_names_compared_whole():
    assert forbidden_modules(["pvw_tpu_torch", "pvw_tpu_torch.ops", "torch"]) == []
    assert forbidden_modules(["pvw_tpu.ops"]) == ["pvw_tpu"]
    assert forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == [
        "flax", "jax", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    for path in (REPO / "portbench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("pvw_tpu", "pvw_tpu_torch", "jax", "jaxlib")
    out = subprocess.run(
        [sys.executable, "-c", "import sys, portbench.reference.pvw, portbench.system, "
         "portbench.harness, portbench.trace, portbench.roofline; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'pvw_tpu', 'pvw_tpu_torch', 'jax', 'jaxlib', 'flax'}))"],
        cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_harness_loads_the_port_and_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", "import sys, pvw_tpu_torch, portbench.harness as h; "
         "print(h.forbidden_modules())"],
        cwd=REPO, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
