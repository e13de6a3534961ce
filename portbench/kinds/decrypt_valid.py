"""Parties decrypting their shares of a round's valid dealers
(``decrypt_valid_shares``, the upstream pvw_valid_dec flow).

Traffic keys: ``round_pool`` (rounds that set-up encrypts through the
program), ``valid_share`` (the share of each round's dealers, drawn from
the seed, that is valid), ``threshold`` (``[a, b]``: ceil(n a / b), or a
count), ``trace_requests``, and optionally ``subset`` (``[lo, hi]``: each
request decrypts a count of that round's valid dealers drawn uniformly in
[lo, hi], the dealers drawn among them; without it, all of them).

Request i takes slot i mod n: a party (a permutation of all n, so each
party's key is new to the call, as after a round), a round and its dealers,
all drawn from the seed in set-up. Every returned share is judged against
the scalar the benchmark encrypted, and one call below the threshold must
abort."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference import pvw as ref
from portbench.system import U64_MAX, Loop, System, p95, sync, u64_pool


class Mix(Loop):
    def __init__(self, cell, seed: int, devices):
        import pvw_tpu_torch as P

        super().__init__()
        self.sys = System(cell.config, seed, devices[0])
        self.cfg, tr = cell.config, cell.traffic
        n = self.cfg["n"]
        rng = np.random.default_rng([seed & U64_MAX, 2])
        pool = tr["round_pool"]
        self.shares = u64_pool(rng, pool, n)
        self.cts = [P.encrypt_all_party_shares_batched(self.shares[r], self.sys.gpk,
                                                       ref.fold_in(self.sys.key(4), r))
                    for r in range(pool)]
        self.valid = [sorted(int(d) for d in rng.choice(n, int(n * tr["valid_share"]),
                                                        replace=False)) for _ in range(pool)]
        t = tr["threshold"]
        self.threshold = -(-n * t[0] // t[1]) if isinstance(t, list) else int(t)
        parties = rng.permutation(n)
        rounds = rng.integers(0, pool, size=n)
        if "subset" in tr:
            lo, hi = tr["subset"]
            counts = rng.integers(lo, hi, size=n, endpoint=True)
            dealers = [sorted(int(d) for d in rng.choice(self.valid[r], c, replace=False))
                       for r, c in zip(rounds, counts)]
        else:
            dealers = [self.valid[r] for r in rounds]
        self.asks = [(int(p), int(r), d) for p, r, d in zip(parties, rounds, dealers)]
        self.coeffs = self.sys.coeffs.cpu().numpy()
        self.answers: list[tuple] = []
        sync(self.sys.device)

    def _decrypt(self, party: int, r: int, dealers):
        import pvw_tpu_torch as P

        sk = P.SecretKey(self.sys.params, self.coeffs[party])
        t = time.perf_counter()
        out = P.decrypt_valid_shares(self.cts[r], dealers, self.threshold, sk, party)
        return out, time.perf_counter() - t

    def warm(self) -> None:
        p, r, dealers = self.asks[-1]
        self._decrypt(p, r, dealers)

    def request(self, i: int) -> float:
        slot = i % len(self.asks)
        p, r, dealers = self.asks[slot]
        out, lat = self._decrypt(p, r, dealers)
        self.answers.append(self._answer(slot, out))
        return lat

    def _answer(self, slot: int, out) -> tuple:
        """(slot, dealers in the order asked, shares as uint64): kept as
        arrays, so the window's garbage collections do not grow with the
        answers it holds."""
        return (slot, [d for d, _ in out] == self.asks[slot][2],
                np.array([v for _, v in out], np.uint64))

    def end_to_end(self, window_s: float) -> dict:
        return {"decrypt_p95_ms": p95(self.latencies) * 1e3}

    def collect(self) -> dict:
        from pvw_tpu_torch.errors import InsufficientValidCiphertexts

        try:
            self._decrypt(self.asks[0][0], 0, self.valid[0][:self.threshold - 1])
            aborted = False
        except InsufficientValidCiphertexts:
            aborted = True
        out = {"answers": self.answers, "aborted": aborted}
        self.answers = []
        return out

    def free(self) -> None:
        self.cts = []
        self.sys.release()

    def control(self, out: dict, scheme) -> dict:
        """The reference decryption in the program's place with a decode
        from the top gadget coefficient alone (no sequential rounding)."""
        answers = []
        for slot, *_ in out["answers"]:
            p, r, dealers = self.asks[slot]
            cols = torch.as_tensor(dealers, device=scheme.ring.device)
            c1 = self.cts[r].c1.channel().index_select(3, cols).permute(2, 3, 0, 1)
            c2 = self.cts[r].c2.channel()[:, :, p].index_select(2, cols).permute(2, 0, 1)
            z = scheme.noisy_messages(torch.from_numpy(self.coeffs[p]), c1, c2)
            vals = [ref.decode_one_coefficient(scheme, zz) for zz in ref.lift(scheme, z)]
            answers.append(self._answer(slot, list(zip(dealers, vals))))
        return {**out, "answers": answers}

    def judge(self, out: dict, scheme) -> dict:
        """Wrong answers, limit 0: shares that differ from the scalar's
        exact decryption, and a call below the threshold that did not abort."""
        Q = scheme.ring.Q
        wrong = 0
        for slot, in_order, got in out["answers"]:
            p, r, dealers = self.asks[slot]
            want = np.array([ref.expected_share(int(self.shares[r][d, p]), Q)
                             for d in dealers], np.uint64)
            if not in_order or len(got) != len(want):
                wrong += len(want)
            else:
                wrong += int((got != want).sum())
        missing = 0 if out["aborted"] else 1
        return {"wrong_answers": (wrong + missing, 0),
                "decryptions_checked": (len(out["answers"]), None),
                "share_mismatches": (wrong, None), "abort_missing": (missing, None)}
