"""Whole runs of small cells on the CPU, the chip's look skipped: sound
runs are correct; each fault a cell can have, planted in the program's
timed path, and the control make ``correct`` false; each mix repeats
exactly from a seed."""

import time

import numpy as np
import pytest
import torch
from pb_small import small_root  # noqa: F401

import pvw_tpu_torch as P
from portbench import control, harness, spec

CELLS = ["small-ref-deal", "small-ref-threshold", "small-t256-deal", "small-t256-threshold",
         "small-ref-subset"]
SEED = 2**31 + 977


def run(root, name, seed=SEED, trace=False):
    return harness.run_cell(spec.load_cell(name, root), seed, 0.3, trace, ["cpu"],
                            time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(small_root, name):
    res = run(small_root, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


def test_traced_run_is_correct_and_names_its_window(small_root):
    res = run(small_root, "small-t256-deal", trace=True)
    # six untraced, the same six traced, two more with host ops: all judged
    assert res["correct"] and res["attempted"] == 6 + 6 + 2
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def _halve_dealers(real):
    def broken(all_shares, gpk, key):
        ct = real(all_shares, gpk, key)
        for poly in (ct.c1, ct.c2):
            ch = poly.channel()
            ch[..., ch.shape[-1] // 2:] = 0           # half of the batch left out
        return ct
    return broken


def _alter_residue(real):
    def broken(all_shares, gpk, key):
        ct = real(all_shares, gpk, key)
        ch = ct.c2.channel()
        ch.view(-1)[7] = (ch.view(-1)[7] + 1) % int(gpk.params.ring.moduli[0])
        return ct
    return broken


def _halve_valid(real):
    def broken(cts, valid, threshold, sk, party):
        out = real(cts, valid, threshold, sk, party)
        return out[:len(out) // 2]                    # half of the batch left out
    return broken


def _alter_share(real):
    def broken(cts, valid, threshold, sk, party):
        out = real(cts, valid, threshold, sk, party)
        d, v = out[-1]
        return out[:-1] + [(d, v ^ 1)]                # an answer altered where produced
    return broken


FAULTS = [("small-ref-deal", "encrypt_all_party_shares_batched", _halve_dealers),
          ("small-t256-deal", "encrypt_all_party_shares_batched", _alter_residue),
          ("small-ref-threshold", "decrypt_valid_shares", _halve_valid),
          ("small-t256-threshold", "decrypt_valid_shares", _alter_share),
          ("small-ref-subset", "decrypt_valid_shares", _alter_share)]


@pytest.mark.parametrize("name,entry,fault", FAULTS,
                         ids=[f"{f[0]}-{f[2].__name__}" for f in FAULTS])
def test_fault_in_the_timed_path_fails(small_root, monkeypatch, name, entry, fault):
    real = getattr(P, entry)
    # set-up encrypts the threshold pool through the same entry: break it
    # only once set-up is over, from the first timed request on
    state = {"on": False}
    broken = fault(real)
    monkeypatch.setattr(P, entry, lambda *a: (broken if state["on"] else real)(*a))
    cell = spec.load_cell(name, small_root)
    mix = spec.kind(cell.traffic, cell.root)
    orig = mix.warm

    def warm(self):
        orig(self)
        state["on"] = True
    monkeypatch.setattr(mix, "warm", warm)
    res = run(small_root, name)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_sound_reads_zero(small_root, name):
    cell = spec.load_cell(name, small_root)
    r = control.control_readings(cell, SEED, 2, "cpu")
    compared = "residue_mismatches" if name.endswith("deal") else "wrong_answers"
    assert r["sound"][compared] == 0 and r["control"][compared] > 0


@pytest.mark.parametrize("traffic", ["deal", "threshold", "subset"])
def test_mix_repeats_from_a_seed(small_root, traffic):
    cell = spec.load_cell(f"small-ref-{traffic}", small_root)

    def inputs(seed):
        mix = spec.kind(cell.traffic, cell.root)(cell, seed, ["cpu"])
        if traffic == "deal":
            return ([p.copy() for p in mix.pool], mix.round_keys[:8].clone(),
                    sorted(mix.keep), mix.sys.coeffs.clone())
        return ([s.copy() for s in mix.shares], mix.valid, mix.asks,
                [c.c2.channel().clone() for c in mix.cts])

    def same(a, b):
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, torch.Tensor):
            return torch.equal(a, b)
        if isinstance(a, np.ndarray):
            return np.array_equal(a, b)
        return a == b

    assert same(inputs(SEED), inputs(SEED))
    assert not same(inputs(SEED), inputs(SEED + 1))


def test_subset_requests_take_counts_from_their_range(small_root):
    cell = spec.load_cell("small-ref-subset", small_root)
    mix = spec.kind(cell.traffic, cell.root)(cell, SEED, ["cpu"])
    counts = {len(d) for _, r, d in mix.asks}
    assert counts <= set(range(3, 7)) and len(counts) > 1
    assert all(set(d) <= set(mix.valid[r]) and d == sorted(d) for _, r, d in mix.asks)
    assert mix.threshold == 2
