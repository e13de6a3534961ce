"""The port's root surface and examples against the JAX package's: the
root names and ``prelude`` cover ``pvw_tpu``'s, the sampling exports cover
``pvw_tpu.sampling``'s, every module of ``pvw_tpu/`` has its counterpart
at the same path (``ops/pallas_modmat.py`` lives on as
``ops/fused_modmat.py`` + ``csrc/``), and each example of
``pvw_tpu_torch.examples`` runs at a tiny size on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pvw_tpu as J
import pvw_tpu.sampling as JS
import pvw_tpu_torch as P
import pvw_tpu_torch.sampling as TS
from pvw_tpu_torch.examples import interop_exchange, pvw, pvw_sharded, pvw_valid_dec

ROOT = Path(__file__).resolve().parents[1]


def public(ns):
    return {n for n in vars(ns) if not n.startswith("_")}


def test_root_names_cover_the_jax_package():
    missing = public(J) - public(P)
    assert missing == set()
    for name in public(J):
        assert getattr(P, name) is not None, name
    for name in P.__all__:
        assert hasattr(P, name), name
    assert {"settings", "prelude", "sample_uniform_coefficients",
            "sample_discrete_gaussian_vec", "sample_bigint_normal_vec"} <= set(P.__all__)
    assert P.settings is P.config.settings


def test_prelude_covers_the_jax_prelude():
    assert public(J.prelude) - public(P.prelude) == set()
    for name in public(J.prelude):
        got = getattr(P.prelude, name)
        assert got is getattr(P, name), name
        assert got.__module__.startswith("pvw_tpu_torch"), name


def test_sampling_exports_cover_the_jax_package():
    assert set(JS.__all__) - set(TS.__all__) == set()
    for name in TS.__all__:
        obj = getattr(TS, name)
        assert callable(obj) or obj == getattr(JS, name), name
        if callable(obj):
            assert obj.__module__.startswith("pvw_tpu_torch"), name


def test_every_module_has_its_counterpart():
    jax_files = {p.relative_to(ROOT / "pvw_tpu") for p in (ROOT / "pvw_tpu").rglob("*.py")}
    port_files = {p.relative_to(ROOT / "pvw_tpu_torch")
                  for p in (ROOT / "pvw_tpu_torch").rglob("*.py")}
    assert {str(p) for p in jax_files - port_files} == {"ops/pallas_modmat.py"}


EXAMPLES = {
    "pvw": (pvw, ["--parties", "3", "--dimension", "8"], "All shares recovered correctly."),
    "pvw_valid_dec": (pvw_valid_dec, ["--dimension", "16"],
                      "All valid shares recovered correctly."),
    "pvw_sharded": (pvw_sharded, ["--devices", "4", "--parties", "8", "--dimension", "8",
                                  "--dealers", "4"], "sharded deployment demo OK"),
    "interop_exchange": (interop_exchange, [], "interop exchange OK"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_the_cpu(name, capsys):
    module, args, last = EXAMPLES[name]
    module.main(["--device", "cpu", *args])
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == last
    if name == "pvw_sharded":
        assert "grid: bit-identical=True, decrypt ok=True" in out


def test_example_runs_as_a_module():
    """``python -m pvw_tpu_torch.examples.pvw`` from the repository root,
    with no path edits."""
    out = subprocess.run([sys.executable, "-m", "pvw_tpu_torch.examples.pvw", "--device", "cpu",
                          "--parties", "3", "--dimension", "8"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert "Verification: 9/9 correct" in out.stdout


def test_examples_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    for module, args, _ in EXAMPLES.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            module.main(args)


def test_sharded_example_repeats_the_card():
    devs = pvw_sharded.mesh_devices("cpu", 4)
    assert devs == [torch.device("cpu")] * 4
