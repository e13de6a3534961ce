"""The served (recv, kdim) mesh across processes
(``pvw_tpu_torch.parallel.multiprocess.MeshService``) on the CPU: four gloo
ranks, this process rank 0, at the reference preset's chain and bounds (1,
1172385) with n = 8, k = 32, so that c2 takes the bake route at kdim 2.

Each served round is held byte for byte against the single device's
``encrypt_batch`` of the whole system and against the plain reference of
``portbench/reference/pvw.py``; each rank's keys against the whole key's
rows; a planted plain (non-modular) sum of the partials, and a rank whose
products raise, against the same comparison."""

import time
from pathlib import Path

import numpy as np
import pytest
import torch

import pvw_tpu_torch as P
from pvw_tpu_torch import random as R
from pvw_tpu_torch.config import settings
from pvw_tpu_torch.errors import InvalidParameters
from pvw_tpu_torch.keys import PublicKeyRows
from pvw_tpu_torch.parallel import multiprocess as mp
from pvw_tpu_torch.parallel import sharding

import _mesh_inputs as MI
from portbench.reference import pvw as ref

INPUTS = f"{Path(MI.__file__).resolve()}:inputs"
SEED = 2**31 + 4099
KEY = R.key(SEED)
K_CRS, K_GEN = R.fold_in(KEY, 1), R.fold_in(KEY, 2)


@pytest.fixture
def v3k():
    settings.noise_stream = "v3k"
    yield
    del settings.noise_stream


def service(timeout_s=60, **args):
    return mp.MeshService(MI.params(), K_CRS, K_GEN, INPUTS, {"seed": SEED, **args},
                          world=4, device="cpu", settings={"noise_stream": "v3k"},
                          timeout_s=timeout_s)


def whole_system():
    """The single device's key over every party, from the same coefficients."""
    crs = P.PvwCrs.new(MI.params(), K_CRS, device="cpu")
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_keys_device(MI.coefficients(SEED), K_GEN)
    return crs, gpk


def reference_round(A, B, key, sc):
    """c1 [L, l, k, d] and c2 [L, l, n, d] by the plain reference."""
    p = MI.params()
    cfg = {"k": p.k, "l": p.l, "n": p.n, "secret_variance": p.secret_variance,
           "error_bound_1": p.error_bound_1, "error_bound_2": p.error_bound_2,
           "moduli": list(p.ring.moduli), "settings": {"noise_stream": "v3k"}}
    scheme = ref.Scheme(cfg, "cpu")
    c1, c2 = scheme.encrypt_columns(A, B, torch.arange(p.n), key, torch.arange(MI.DEALERS),
                                    torch.from_numpy(sc.view(np.int64)))
    return c1.permute(2, 3, 0, 1), c2.permute(2, 3, 0, 1)


@pytest.mark.time_limit(120)
def test_served_rounds_equal_the_single_device_and_the_reference(v3k):
    keys = [R.fold_in(KEY, 50 + i) for i in range(2)]
    svc = service()
    try:
        for i, key in enumerate(keys):
            svc.round(i, i % MI.SLOTS, key, keep=True)
        out = svc.collect([0, 1])
    finally:
        svc.close()
    assert all(p.returncode == 0 for p in svc.procs)
    crs, gpk = whole_system()
    for c in out["crs"]:
        assert torch.equal(c, crs.matrix.res)
    assert torch.equal(out["pk"], gpk.matrix.res)
    pool = MI.pool(SEED)
    for i, key in enumerate(keys):
        single = P.encrypt_batch(pool[i % MI.SLOTS], gpk, key)
        c1, c2 = out["rounds"][i]
        assert torch.equal(c1, single.c1.channel()) and torch.equal(c2, single.c2.channel())
        r1, r2 = reference_round(crs.matrix.res, gpk.matrix.res, key, pool[i % MI.SLOTS])
        assert torch.equal(c1, r1) and torch.equal(c2, r2)


def test_row_range_keygen_equals_the_whole_keys_rows():
    p = MI.params()
    crs, gpk = whole_system()
    coeffs = MI.coefficients(SEED)
    a_all, b_all = gpk.encrypt_operands()
    nd = p.ring.num_digits
    for lo, hi in ((0, 4), (4, 8), (3, 5)):
        rows = PublicKeyRows.generate_device(crs, coeffs[lo:hi], K_GEN, lo)
        assert (rows.lo, rows.hi) == (lo, hi)
        assert torch.equal(rows.matrix.res, gpk.matrix.res[lo:hi])
        for c0, kc in ((0, p.k), (0, p.k // 2), (p.k // 2, p.k // 2)):
            a, b = rows.encrypt_operands((c0, kc), with_a=True)
            cols = slice(c0 * nd, (c0 + kc) * nd)
            assert torch.equal(a, a_all[..., cols]) and torch.equal(b, b_all[:, :, lo:hi, cols])
    assert rows.encrypt_operands()[0] is None
    for lo in (-1, p.n - 3):
        with pytest.raises(InvalidParameters, match="not a block"):
            PublicKeyRows.generate_device(crs, coeffs[:4], K_GEN, lo)


@pytest.mark.time_limit(120)
def test_a_plain_sum_of_the_partials_fails_the_comparison(v3k, monkeypatch):
    # the planted sum reaches this process (rank 0) too: put it back after
    monkeypatch.setattr(sharding, "_modsum_gathered", sharding._modsum_gathered)
    key = R.fold_in(KEY, 60)
    svc = service(plant="plain_sum")
    try:
        svc.round(0, 0, key, keep=True)
        out = svc.collect([0])
    finally:
        svc.close()
    crs, gpk = whole_system()
    c1, c2 = out["rounds"][0]
    r1, r2 = reference_round(crs.matrix.res, gpk.matrix.res, key, MI.pool(SEED)[0])
    assert not torch.equal(c1, r1) and not torch.equal(c2, r2)
    q = torch.tensor(MI.params().ring.moduli).reshape(-1, 1, 1, 1)
    assert bool((c2 >= q).any())                     # residues left unreduced
    assert torch.equal(c2 % q, r2)


@pytest.mark.time_limit(120)
def test_launches_are_read_from_every_rank_and_reset():
    from pvw_tpu_torch.ops import fused_modmat as fm

    fn, attr = fm.launch_counters()[fm.KERNEL]
    svc = service(plant="launches")
    try:
        setattr(fn, attr, 1)            # rank 0, this process, is not planted
        first = svc.launches(reset=True)
        second = svc.launches()
    finally:
        svc.close()
    assert [c[fm.KERNEL] for c in first] == [1, 2, 3, 4]
    assert all(set(c) == set(fm.launch_counters()) for c in first)
    assert all(v == 0 for c in second for v in c.values())
    assert getattr(fn, attr) == 0


@pytest.mark.time_limit(120)
def test_a_rank_that_fails_fails_the_round_and_a_dead_rank_the_next(v3k):
    svc = service(timeout_s=10, plant="fail", rank=2)
    try:
        t = time.perf_counter()
        with pytest.raises(RuntimeError, match=r"failed on rank\(s\) \[2, 3\]"):
            svc.round(0, 0, R.fold_in(KEY, 70))
        assert time.perf_counter() - t < 60           # the partner waited its timeout
        with pytest.raises(RuntimeError, match="failed earlier"):
            svc.round(1, 0, R.fold_in(KEY, 71))
    finally:
        svc.close()
    svc = service()
    try:
        svc.procs[0].kill()
        svc.procs[0].wait()
        with pytest.raises(RuntimeError, match="rank 1 rc="):
            svc.round(0, 0, R.fold_in(KEY, 72))
    finally:
        svc.close()


BUILDER = """
import sys
from pathlib import Path
from pvw_tpu_torch.ops import _build
root = Path(sys.argv[1])
_build.CSRC, _build.BUILD_DIR = root / "csrc", root / "kernels"
_build.nvcc_path = lambda: str(root / "nvcc")
_build.build_all(["k"])
print(_build.target("k").read_text().count("x"))
"""

# writes its output slowly, a line at a time, so that builds overlap
FAKE_NVCC = """#!{python}
import sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    for _ in range(20):
        f.write("x" * 1000 + chr(10))
        f.flush()
        time.sleep(0.01)
print("ptxas info    : Used 1 registers")
"""


def test_ranks_building_at_once_each_rename_a_whole_library_into_place(tmp_path):
    """Four processes building the same kernel at once (the mesh's ranks,
    were the libraries not built before they start) each write their own
    temporary file and rename it into place: every one loads a whole library
    and no temporary is left."""
    import subprocess
    import sys

    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("// a kernel\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    procs = [subprocess.Popen([sys.executable, "-c", BUILDER, str(tmp_path)],
                              stdout=subprocess.PIPE, text=True,
                              cwd=Path(__file__).resolve().parents[1]) for _ in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4
    assert [o.split()[-1] for o in outs] == ["20000"] * 4
    built = sorted(f.name for f in (tmp_path / "kernels").iterdir())
    assert len(built) == 2 and built[0].endswith(".log") and built[1].endswith(".so")
