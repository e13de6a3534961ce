"""PVSS rounds: all n dealers' vectors of n uniform u64 scalars in one
``encrypt_all_party_shares_batched``, a fresh key each round.

Traffic keys: ``scalar_pool`` (round i takes the scalars of entry i mod the
pool, made in set-up; the upload is in the call), ``trace_requests``, and
``check.rounds``: the rounds judged whole, the first, ``rounds - 2`` drawn
from the seed among the first 32, and the last, with the CRS and every
public key."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import pvw as ref
from portbench.system import U64_MAX, Loop, System, p95, sync, u64_pool


class Mix(Loop):
    def __init__(self, cell, seed: int, devices):
        super().__init__()
        self.sys = System(cell.config, seed, devices[0])
        self.cfg, tr = cell.config, cell.traffic
        rng = np.random.default_rng([seed & U64_MAX, 1])
        self.pool = u64_pool(rng, tr["scalar_pool"], self.cfg["n"])
        self.keep = {0, *(int(i) for i in rng.choice(np.arange(1, 32),
                                                      tr["check"]["rounds"] - 2, replace=False))}
        self.k_deal = self.sys.key(3)
        self.round_keys = ref.fold_in(self.k_deal, torch.arange(4096))
        self.kept: dict = {}
        self.last = None

    def round_key(self, i: int) -> torch.Tensor:
        """fold_in(k_deal, i), from a table that doubles when a window outruns it."""
        if i >= len(self.round_keys):
            self.round_keys = ref.fold_in(self.k_deal, torch.arange(2 * i))
        return self.round_keys[i]

    def _encrypt(self, i: int, key):
        import pvw_tpu_torch as P

        return P.encrypt_all_party_shares_batched(self.pool[i % len(self.pool)],
                                                  self.sys.gpk, key)

    def warm(self) -> None:
        self._encrypt(0, self.sys.key(5))
        sync(self.sys.device)

    def request(self, i: int) -> float:
        key = self.round_key(i)
        t = time.perf_counter()
        ct = self._encrypt(i, key)
        sync(self.sys.device)
        lat = time.perf_counter() - t
        self.last = (i, ct)
        if i in self.keep:
            self.kept[i] = ct
        return lat

    def end_to_end(self, window_s: float) -> dict:
        return {"enc_per_s": len(self.latencies) * self.cfg["n"] / window_s,
                "deal_p95_ms": p95(self.latencies) * 1e3}

    def collect(self) -> dict:
        """The program's outputs to judge: the CRS, B, the kept rounds'
        channel-major c1 [L, l, k, n] and c2 [L, l, n, n]."""
        if self.last is not None:
            self.kept[self.last[0]] = self.last[1]
        out = {"crs": self.sys.crs.matrix.res, "pk": self.sys.gpk.matrix.res,
               "rounds": {i: (ct.c1.channel(), ct.c2.channel())
                          for i, ct in sorted(self.kept.items())}}
        self.last, self.kept = None, {}
        return out

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.sys.release()

    def control(self, out: dict, scheme) -> dict:
        """The reference in the program's place with a 32-bit encode (the
        scalars' high words dropped): its rounds."""
        A, B = self._reference_keys(scheme)
        return {**out, "rounds": {i: self._reference_round(scheme, A, B, i, 32)
                                  for i in out["rounds"]}}

    def _reference_keys(self, scheme):
        A = scheme.crs(self.sys.k_crs)
        every = torch.arange(self.cfg["n"], device=scheme.ring.device)
        return A, scheme.public_rows(A, self.sys.coeffs, self.sys.k_gen, every)

    def _reference_round(self, scheme, A, B, i: int, bits: int = 64):
        """Round i's c1, c2 by the reference, channel-major as the program's."""
        every = torch.arange(self.cfg["n"])
        sc = torch.from_numpy(self.pool[i % len(self.pool)].view(np.int64))
        c1, c2 = scheme.encrypt_columns(A, B, every, self.round_key(i), every, sc, bits)
        return c1.permute(2, 3, 0, 1), c2.permute(2, 3, 0, 1)

    def judge(self, out: dict, scheme) -> dict:
        """Residues that differ from the reference's, limit 0: the CRS, B
        and every residue of the kept rounds (each part beside it)."""
        A, B = self._reference_keys(scheme)
        c1 = c2 = 0
        for i, (p1, p2) in out["rounds"].items():
            r1, r2 = self._reference_round(scheme, A, B, i)
            c1 += int((r1 != p1.to(r1.device)).sum())
            c2 += int((r2 != p2.to(r2.device)).sum())
            del r1, r2
        crs = int((A != out["crs"].to(A.device)).sum())
        pk = int((B != out["pk"].to(B.device)).sum())
        return {"residue_mismatches": (crs + pk + c1 + c2, 0),
                "rounds_checked": (len(out["rounds"]), None), "crs": (crs, None),
                "public_keys": (pk, None), "c1": (c1, None), "c2": (c2, None)}
