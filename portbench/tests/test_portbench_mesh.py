"""The mesh cell's kind (``deal_mesh``) on the CPU: a root of its own with
the configuration cut to n = 8, k = 32 (the reference preset's chain and
bounds, so c2 takes the bake route) on four gloo ranks, this process rank
0. A sound run is correct; a fault planted in the kdim combination is not;
``k1_roofline.mesh`` reads kernel 1's least time at the shard's shapes."""

import json
import shutil
import time
from types import SimpleNamespace

import pytest
from pb_small import REPO

from portbench import harness, roofline, spec

SEED = 2**31 + 1973
CELL = "small-mesh4"


@pytest.fixture(scope="module")
def mesh_root(tmp_path_factory):
    """A root whose BENCHMARK.json adds ``small-mesh4``: ``ref128-n8192``'s
    file with n and k cut, the ``deal_mesh`` traffic judging 4 dealers, and
    the mesh cell's metrics."""
    root = tmp_path_factory.mktemp("portbench_mesh_root")
    (root / "portbench" / "configs").mkdir(parents=True)
    for part in ("traffic", "kinds", "metrics"):
        shutil.copytree(REPO / "portbench" / part, root / "portbench" / part)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((REPO / "portbench" / "configs" / "ref128-n8192.json").read_text())
    cfg.update(name="small-mesh", n=8, k=32)
    (root / "portbench" / "configs" / "small-mesh.json").write_text(json.dumps(cfg))
    traffic = json.loads((REPO / "portbench" / "traffic" / "deal_mesh.json").read_text())
    traffic["check"]["dealers"] = 4
    (root / "portbench" / "traffic" / "small_mesh.json").write_text(json.dumps(traffic))
    bench["configs"].append({"name": "small-mesh", "source": "test", "reduced": ["k", "n"],
                             "file": "portbench/configs/small-mesh.json", "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "small-mesh", "traffic": "small_mesh",
                               "chips": 4, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "ref128-n8192-mesh4" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, trace=False):
    return harness.run_cell(spec.load_cell(CELL, root), SEED, 0.3, trace, ["cpu"],
                            time.perf_counter())


@pytest.mark.time_limit(180)
def test_sound_run_is_correct(mesh_root):
    res = run(mesh_root)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"enc_per_s", "deal_p95_ms", "setup_s"}
    checks = res["checks"]
    assert checks["rounds_checked"]["value"] >= 1 and checks["residue_mismatches"]["value"] == 0


@pytest.mark.time_limit(180)
def test_a_fault_in_the_combination_is_not_correct(mesh_root, monkeypatch):
    """Rank 0 (this process) adds its blocks' partials without reducing."""
    from pvw_tpu_torch.parallel import sharding

    monkeypatch.setattr(sharding, "_modsum_gathered",
                        lambda parts, ring, device: sum(p.to(device) for p in parts))
    res = run(mesh_root)
    assert not res["correct"]
    assert res["checks"]["c2"]["value"] > 0 and res["failed"] == 0


def test_k1_roofline_reads_the_shards_least_time():
    cfg = json.loads((REPO / "portbench" / "configs" / "ref128-n8192.json").read_text())
    read = spec.reader("k1_roofline.mesh", REPO)
    L, l, n, k, nd = len(cfg["moduli"]), cfg["l"], cfg["n"], cfg["k"], roofline.num_digits(cfg)
    kc = k // 2

    def least(rows, noise_digits):
        """int8 products at the int8 rate or bytes at HBM's, the k block's."""
        macs = L * l * rows * kc * n * nd * nd
        nbytes = (L * l * rows * kc * nd + L * l * nd * kc * nd * n
                  + l * noise_digits * rows * n + 8 * L * l * rows * n)
        return roofline.least_s(macs, nbytes)

    # c1 on recv row 0: k rows, bound 1's one digit; c2's shard: n / 2 rows,
    # no noise planes (its bound has no signed digits), no encode
    assert roofline.signed_digits(cfg["error_bound_2"]) == 0
    shard = least(k, 1) + least(n // 2, 0)
    trace = SimpleNamespace(requests=4, kernel_us=lambda name: 4 * 2 * shard * 1e6)
    assert read({"trace": trace, "config": cfg}) == pytest.approx(50.0)
    assert shard < roofline.round_products_least_s(cfg) / 3


@pytest.mark.parametrize("mesh", [[4, 1], [1, 4]])
def test_a_mesh_of_another_kdim_raises_before_any_rank_starts(mesh, monkeypatch):
    """The served mesh's kdim is fixed: a configuration that asks for another
    would run (2, 2) under a metric reckoned at its own shape."""
    from pvw_tpu_torch.parallel import multiprocess

    def started(*args, **kwargs):
        raise AssertionError("a rank started")

    monkeypatch.setattr(multiprocess, "MeshService", started)
    cfg = json.loads((REPO / "portbench" / "configs" / "ref128-n8192.json").read_text())
    traffic = json.loads((REPO / "portbench" / "traffic" / "deal_mesh.json").read_text())
    mix = spec.kind(traffic, REPO)
    with pytest.raises(ValueError, match="kdim is 2"):
        mix(SimpleNamespace(config={**cfg, "mesh": mesh}, traffic=traffic), SEED, ["cpu"])
