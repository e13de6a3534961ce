"""The system under test and the closed loop that drives it.

:class:`System` builds a configuration's deployment through the program's
public entry points: the program's settings as the configuration states
them, parameters from the configuration's own numbers, the CRS, batch
keygen of all n parties from secret coefficients that the benchmark draws
on the card from the seed, and the encryption operands. :class:`Loop` is a
closed loop with one caller; each kind of traffic
(``portbench/kinds/<kind>.py``) subclasses it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .reference import pvw as ref

U64_MAX = (1 << 64) - 1


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def p95(values) -> float:
    """The nearest-rank 95th percentile of every value."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def u64_pool(rng, count: int, n: int) -> list[np.ndarray]:
    return [rng.integers(0, U64_MAX, size=(n, n), dtype=np.uint64, endpoint=True)
            for _ in range(count)]


def apply_settings(stated: dict) -> None:
    """Every knob of ``pvw_tpu_torch.settings`` as the configuration states
    it, the others at their defaults: the environment selects nothing."""
    import pvw_tpu_torch as P

    knobs = P.settings.describe()
    unknown = sorted(set(stated) - set(knobs))
    if unknown:
        raise KeyError(f"the program has no settings {unknown}; it has {sorted(knobs)}")
    P.settings.reset()
    for name in knobs:
        setattr(P.settings, name, stated.get(name, getattr(type(P.settings), name).default))


class System:
    """One configuration's deployment, made from ``seed``: the keys are
    threefry keys the benchmark derives (the program's key format), the
    secret coefficients centered-binomial draws of a ``torch.Generator``."""

    def __init__(self, cfg: dict, seed: int, device):
        import pvw_tpu_torch as P

        apply_settings(cfg.get("settings", {}))
        self.cfg, self.device = cfg, torch.device(device)
        self.params = (P.PvwParametersBuilder().set_parties(cfg["n"]).set_dimension(cfg["k"])
                       .set_l(cfg["l"]).set_moduli(cfg["moduli"])
                       .set_secret_variance(cfg["secret_variance"])
                       .set_error_bounds_u32(cfg["error_bound_1"], cfg["error_bound_2"])
                       .build())
        self.master = ref.key(seed & U64_MAX)
        self.k_crs, self.k_gen = ref.fold_in(self.master, 1), ref.fold_in(self.master, 2)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed & U64_MAX)
        w = torch.randint(0, 1 << 32, (2, cfg["n"], cfg["k"], cfg["l"]), generator=gen,
                          device=self.device, dtype=torch.int64)
        self.coeffs = ref.cbd_from_words(w[0], w[1], cfg["secret_variance"]).to(torch.int32)
        del w
        self.crs = P.PvwCrs.new(self.params, self.k_crs, device=self.device)
        self.gpk = P.GlobalPublicKey(self.crs)
        self.gpk.generate_all_keys_device(self.coeffs, self.k_gen)
        self.gpk.encrypt_operands()

    def key(self, i: int) -> torch.Tensor:
        return ref.fold_in(self.master, i)

    def release(self) -> None:
        self.gpk = self.crs = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Loop:
    """A closed loop with one caller: ``request(i)`` makes request i and
    returns its latency in seconds. Successive windows go on numbering the
    requests where the last one stopped; ``run_count`` can also make
    requests again, from a number given.

    A kind of traffic is ``portbench/kinds/<kind>.py`` exporting ``Mix``, a
    subclass built as ``Mix(cell, seed, devices)`` (``devices``: one torch
    device a chip the cell asks for) that also gives ``warm()``,
    ``end_to_end(window_s)``, ``collect()``, ``free()``,
    ``control(out, scheme)`` and ``judge(out, scheme)``."""

    def __init__(self):
        self.latencies: list[float] = []
        self.attempted = self.failed = self.next = 0

    def _call(self, i: int) -> None:
        self.attempted += 1
        self.next = max(self.next, i + 1)
        try:
            self.latencies.append(self.request(i))
        except Exception as e:          # a request that never answers fails the run
            self.failed += 1
            self.error = repr(e)

    def run_for(self, seconds: float) -> float:
        """Whole requests until ``seconds`` have passed; the window's length."""
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._call(self.next)
        return time.perf_counter() - t0

    def run_count(self, count: int, first: int | None = None) -> None:
        """Requests ``first`` to ``first + count - 1`` (the next ones by default)."""
        first = self.next if first is None else first
        for i in range(first, first + count):
            self._call(i)
