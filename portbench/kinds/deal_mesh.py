"""PVSS rounds on the (recv, kdim) mesh across processes: all n dealers'
vectors of n uniform u64 scalars a round, a fresh key each round, served by
``pvw_tpu_torch.parallel.multiprocess.MeshService``. This process is rank 0
on the first chip and the other ranks one a chip; each rank makes and holds
only its recv row's public keys and scalars. The configuration's ``mesh``
is (recv, kdim): recv x kdim ranks, the cell's chips; kdim must be the
served mesh's (``multiprocess.KDIM``), or the kind raises.

Traffic keys: ``scalar_pool`` (round i takes slot i mod the pool; every rank
makes the same pool from the seed and keeps its recv row's columns; the
upload is in the call), ``trace_requests``, ``check.rounds`` (the rounds
judged: the first, ``rounds - 2`` drawn from the seed among the first 32,
and the last) and ``check.dealers`` (c2's dealer columns judged, drawn from
the seed). Judged, after the ranks are released: every rank's CRS, every
row of B, and each judged round's c1 whole and c2 at every party row and
the drawn dealers, against the plain reference, in blocks on rank 0's
device."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench.reference import pvw as ref
from portbench.system import U64_MAX, Loop, apply_settings, p95, u64_pool

WARM_ROUNDS = 2
BLOCK = 1024          # party rows a block of the reference


def params_of(cfg: dict):
    import pvw_tpu_torch as P

    return (P.PvwParametersBuilder().set_parties(cfg["n"]).set_dimension(cfg["k"])
            .set_l(cfg["l"]).set_moduli(cfg["moduli"])
            .set_secret_variance(cfg["secret_variance"])
            .set_error_bounds_u32(cfg["error_bound_1"], cfg["error_bound_2"]).build())


def coefficients(cfg: dict, seed: int, device, lo: int, hi: int) -> torch.Tensor:
    """The secret coefficients of parties [lo, hi), int32 [hi - lo, k, l]:
    centered-binomial draws of a ``torch.Generator`` seeded with ``seed``,
    the same draw for every range (the deal kind's ``System``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & U64_MAX)
    w = torch.randint(0, 1 << 32, (2, cfg["n"], cfg["k"], cfg["l"]), generator=gen,
                      device=device, dtype=torch.int64)
    return ref.cbd_from_words(w[0, lo:hi], w[1, lo:hi], cfg["secret_variance"]).to(torch.int32)


def judged(cfg: dict, traffic: dict, seed: int):
    """(the judged rounds but the last, the judged dealers, sorted)."""
    rng = np.random.default_rng([seed & U64_MAX, 2])
    keep = {0, *(int(i) for i in rng.choice(np.arange(1, 32), traffic["check"]["rounds"] - 2,
                                            replace=False))}
    return keep, np.sort(rng.choice(cfg["n"], traffic["check"]["dealers"], replace=False))


def scalar_pool(cfg: dict, traffic: dict, seed: int) -> list[np.ndarray]:
    return u64_pool(np.random.default_rng([seed & U64_MAX, 1]), traffic["scalar_pool"],
                    cfg["n"])


def rank_inputs(view) -> dict:
    """A rank's inputs (``MeshService``'s input function): its recv rows'
    coefficients, its rows' columns of every pool slot, the judged dealers."""
    cfg, traffic, seed = view.args["config"], view.args["traffic"], view.args["seed"]
    pool, (_, cols) = scalar_pool(cfg, traffic, seed), judged(cfg, traffic, seed)
    coeffs = {r: coefficients(cfg, seed, view.device, lo, hi) for r, (lo, hi) in view.rows.items()}
    slots = [{r: np.ascontiguousarray(p[:, lo:hi]) for r, (lo, hi) in view.rows.items()}
             for p in pool]
    del pool
    return {"coeffs": coeffs, "pool": slots, "keep_cols": cols}


class Mix(Loop):
    def __init__(self, cell, seed: int, devices):
        from pvw_tpu_torch.parallel.multiprocess import KDIM, MeshService

        super().__init__()
        self.cfg, self.traffic, self.seed = cell.config, cell.traffic, seed
        recv, kdim = self.cfg["mesh"]
        if kdim != KDIM:
            raise ValueError(f"mesh {self.cfg['mesh']}: the served mesh's kdim is {KDIM}")
        apply_settings(self.cfg.get("settings", {}))
        self.params = params_of(self.cfg)
        self.master = ref.key(seed & U64_MAX)
        self.k_crs, self.k_gen = ref.fold_in(self.master, 1), ref.fold_in(self.master, 2)
        self.k_deal = ref.fold_in(self.master, 3)
        self.round_keys = ref.fold_in(self.k_deal, torch.arange(4096))
        self.keep, self.cols = judged(self.cfg, self.traffic, seed)
        self.slots = self.traffic["scalar_pool"]
        self.svc = MeshService(
            self.params, self.k_crs, self.k_gen, f"{Path(__file__).resolve()}:rank_inputs",
            {"config": self.cfg, "traffic": self.traffic, "seed": seed},
            world=recv * kdim, device=torch.device(devices[0]).type,
            settings=self.cfg.get("settings", {}))
        self.kept, self.last = set(), None

    def round_key(self, i: int) -> torch.Tensor:
        """fold_in(k_deal, i), from a table that doubles when a window outruns it."""
        if i >= len(self.round_keys):
            self.round_keys = ref.fold_in(self.k_deal, torch.arange(2 * i))
        return self.round_keys[i]

    def warm(self) -> None:
        t = time.perf_counter()
        for w in range(WARM_ROUNDS):
            self.svc.round(-1 - w, 0, ref.fold_in(self.master, 5 + w))
        print("mesh_setup_ms", json.dumps({**self.svc.setup_ms,
                                           "warm_ms": (time.perf_counter() - t) * 1e3}),
              file=sys.stderr)

    def request(self, i: int) -> float:
        key = self.round_key(i)
        t = time.perf_counter()
        self.svc.round(i, i % self.slots, key, keep=i in self.keep)
        lat = time.perf_counter() - t
        self.last = i
        if i in self.keep:
            self.kept.add(i)
        return lat

    def end_to_end(self, window_s: float) -> dict:
        return {"enc_per_s": len(self.latencies) * self.cfg["n"] / window_s,
                "deal_p95_ms": p95(self.latencies) * 1e3}

    def collect(self) -> dict:
        """Every rank's CRS, B, and the judged rounds' channel-major c1 [L, l,
        k, n] and c2 [L, l, n, dealers judged], gathered to rank 0."""
        rounds = self.kept | ({self.last} if self.last is not None else set())
        return self.svc.collect(rounds) if rounds else {}

    def free(self) -> None:
        """Release the ranks and drop rank 0's state before the reference runs."""
        self.svc.close()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def _reference_keys(self, scheme):
        n, dev = self.cfg["n"], scheme.ring.device
        A = scheme.crs(self.k_crs)
        coeffs = coefficients(self.cfg, self.seed, dev, 0, n)
        B = torch.cat([scheme.public_rows(A, coeffs[lo:lo + BLOCK], self.k_gen,
                                          torch.arange(lo, min(lo + BLOCK, n), device=dev))
                       for lo in range(0, n, BLOCK)])
        return A, B

    def _reference_round(self, scheme, A, B, sc, i: int, bits: int = 64):
        """Round i's c1 [L, l, k, n] and c2 [L, l, n, judged dealers] by the
        reference; ``sc``: the round's scalars of the judged dealers [D, n]."""
        n, key = self.cfg["n"], self.round_key(i)
        every = torch.arange(n)
        c1, _ = scheme.encrypt_columns(A, B[:1], every[:1], key, every,
                                       torch.zeros((n, 1), dtype=torch.int64), bits)
        cols = torch.from_numpy(self.cols)
        c2 = torch.cat([scheme.encrypt_columns(
            A, B[lo:lo + BLOCK], every[lo:lo + BLOCK], key, cols,
            sc[:, lo:lo + BLOCK], bits)[1] for lo in range(0, n, BLOCK)])
        return c1.permute(2, 3, 0, 1), c2.permute(2, 3, 0, 1)

    def _judged_scalars(self) -> list:
        pool = scalar_pool(self.cfg, self.traffic, self.seed)
        return [torch.from_numpy(p[self.cols].view(np.int64)) for p in pool]

    def control(self, out: dict, scheme) -> dict:
        """The reference in the program's place with a 32-bit encode (the
        scalars' high words dropped): its rounds."""
        A, B = self._reference_keys(scheme)
        sc = self._judged_scalars()
        return {**out, "rounds": {i: self._reference_round(scheme, A, B, sc[i % self.slots], i, 32)
                                  for i in out["rounds"]}}

    def judge(self, out: dict, scheme) -> dict:
        """Residues that differ from the reference's, limit 0: every rank's
        CRS, B, and the judged rounds' c1 and c2 (each part beside it)."""
        if not out:
            return {"residue_mismatches": (1, 0)}
        t = time.perf_counter()
        A, B = self._reference_keys(scheme)
        sc = self._judged_scalars()
        c1 = c2 = 0
        for i, (p1, p2) in out["rounds"].items():
            r1, r2 = self._reference_round(scheme, A, B, sc[i % self.slots], i)
            c1 += int((r1 != p1.to(r1.device)).sum())
            c2 += int((r2 != p2.to(r2.device)).sum())
            del r1, r2
        crs = sum(int((A != c.to(A.device)).sum()) for c in out["crs"])
        pk = int((B != out["pk"].to(B.device)).sum())
        print(f"judge_s {time.perf_counter() - t:.3f}", file=sys.stderr)
        return {"residue_mismatches": (crs + pk + c1 + c2, 0),
                "rounds_checked": (len(out["rounds"]), None), "crs": (crs, None),
                "public_keys": (pk, None), "c1": (c1, None), "c2": (c2, None)}
