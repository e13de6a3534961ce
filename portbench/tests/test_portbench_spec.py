"""Cells, configurations, traffic mixes, kinds of traffic and metric
readers are found by name; a new configuration, mix or kind is a new file
plus a new entry; the program's settings come from the configuration."""

import json

import pytest
from pb_small import REPO, small_root  # noqa: F401

from portbench import roofline, spec
from portbench.system import apply_settings

NAME_CHARS = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_.-")


def test_every_cell_loads_its_files_by_name():
    bench = spec.load_benchmark(REPO)
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], REPO)
        assert cell.config["name"] == w["config"]
        assert callable(spec.kind(cell.traffic, REPO))
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer, w["name"]


def test_every_metric_has_a_reader_file():
    bench = spec.load_benchmark(REPO)
    for m in bench["per_layer"]:
        assert callable(spec.reader(m["name"], REPO))


def test_names_units_and_lengths_keep_the_contract():
    bench = spec.load_benchmark(REPO)
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert set(n) <= NAME_CHARS and len(n) <= 64
    for k in ("configs", "workloads"):
        for x in bench[k]:
            assert 1 <= len(x["why"]) <= 200
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(bench["workloads"]) // 4)
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])


def test_configuration_file_matches_the_program_preset():
    import pvw_tpu_torch.params.presets as presets

    for name, preset in (("ref128-n1024", presets.secure_128_reference),
                         ("t256-n1024", presets.threshold_256bit)):
        cfg = json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())
        p = preset(cfg["n"])
        assert (p.k, p.l, list(p.ring.moduli), p.secret_variance, p.error_bound_1,
                p.error_bound_2, p.ring.num_digits) == (
            cfg["k"], cfg["l"], cfg["moduli"], cfg["secret_variance"], cfg["error_bound_1"],
            cfg["error_bound_2"], roofline.num_digits(cfg))
        assert cfg["settings"] == {"noise_stream": "v3k"}


def test_a_new_configuration_is_a_new_file_and_entry(small_root):
    cell = spec.load_cell("small-ref-deal", small_root)
    assert (cell.config["k"], cell.config["n"]) == (16, 8)
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]   # in no metric's list
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell", small_root)


def test_a_new_mix_or_kind_is_a_new_file(small_root):
    cell = spec.load_cell("small-ref-subset", small_root)     # a traffic file alone
    assert cell.traffic["subset"] == [3, 6]
    assert spec.kind(cell.traffic, small_root).__module__ == "portbench_kinds_decrypt_valid"
    (small_root / "portbench" / "kinds" / "publish.py").write_text(
        "from portbench.system import Loop\n\n\nclass Mix(Loop):\n    pass\n")
    assert spec.kind({"kind": "publish"}, small_root).__name__ == "Mix"
    with pytest.raises(FileNotFoundError, match="kinds/keygen.py"):
        spec.kind({"kind": "keygen"}, small_root)


def test_settings_come_from_the_configuration_alone(monkeypatch):
    import pvw_tpu_torch as P

    monkeypatch.setenv("PVW_TPU_DECODE", "host")
    try:
        apply_settings({"noise_stream": "v3k", "swapped_form": True})
        assert (P.settings.noise_stream, P.settings.swapped_form) == ("v3k", True)
        assert P.settings.decode_mode == "auto"                  # the environment's ignored
        with pytest.raises(KeyError, match="no_such_knob"):
            apply_settings({"no_such_knob": 1})
    finally:
        P.settings.reset()
