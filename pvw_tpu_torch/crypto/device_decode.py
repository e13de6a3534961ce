"""The PVW sequential-rounding decode on the residues' device.

The counterpart of ``pvw_tpu.crypto.device_decode``: the exact
multiprecision decode of ``decode_scalar_pvw_rns`` (``decryption.rs:10-58``)
batched over the messages, in plain torch ops on whatever device holds the
residues, so that decryption fetches 8 bytes a message instead of the
residues. Its design is the JAX package's:

* the ``tmp[i] = z[i]·Δ − z[i+1]`` chain and the Horner fold run in RNS
  (mod each q_j, one Shoup multiply by Δ mod q_j a step) on the PowerBasis
  residues the inner product produced;
* CRT lifts to full integers (multiword magnitudes, :mod:`..ops.mw`) only
  where the algorithm compares or divides: zc[0], the Horner result and
  the l − 1 backward numerators;
* every division is by a static parameter constant (Δ^(l−1) for the
  centered remainder, 2Δ for the sign-split rounding division), so the
  quotients come from host-precomputed reciprocals.

Residues are the port's canonical int64 [d, L, l]; the messages come back
as int64 [d] holding u64 bit patterns. Conventions kept exactly: strict
> q/2 centering, truncated sign-split rounding division, half-mod
centering after the Δ^(l−1) remainder, and the final clamp of
``decryption.rs:226-247`` (a negative value with |v| <= 1000 gives 0, so
does a value >= 2^64). Multiword Δ is covered (config 4's Δ has 65 bits).

The JAX package's ``lax.scan`` loops are Python loops over l here; torch
runs eagerly, so there is no jitted twin. A plan's tables are built once on
the host (:func:`get_plan`) and moved to a device once
(:meth:`DecodePlan.tables`).
"""

from __future__ import annotations

from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import mw
from ..ops.u64 import addmod, as_i64, negmod, shoup_mul64_arr, shoup_mul32_arr, submod
from ..utils.intmath import CrtBasis


def _shoup(w: int, m: int) -> int:
    """The 64-bit Shoup companion floor(w * 2^64 / m) of a constant w < m,
    as its int64 bit pattern."""
    return as_i64((w << 64) // m & 0xFFFFFFFFFFFFFFFF)


class DecodePlan:
    """Static tables for one parameter set, built once on the host."""

    def __init__(self, moduli: tuple[int, ...], ell: int, delta: int) -> None:
        self.moduli = moduli
        self.ell = ell
        self.L = len(moduli)
        crt = CrtBasis(moduli)
        q = crt.q
        self.q = q
        self.delta = int(delta)
        dpow = pow(self.delta, ell - 1)
        self.dpow_mod_q = dpow % q
        # magnitude width: holds L*q (the lift's sum), q + Δ (the division
        # numerators) and the 64-bit output
        self.W = max(3, mw.nw_for_bits(q.bit_length() + 8))
        self.NWq = mw.nw_for_bits(q.bit_length())
        # Δ >= 2 makes Δ^(l-1) <= q/Δ <= q/2: the centered remainder's
        # modulus is positive and the backward quotients stay below q/2
        self.supported = self.delta >= 2 and 0 < self.dpow_mod_q <= q // 2

        host = {
            "q": np.array(moduli, np.int64),
            "qinv": np.array(crt.qhat_inv, np.int64),
            "qinv_sh": np.array([_shoup(w, m) for w, m in zip(crt.qhat_inv, moduli)],
                                np.int64),
            "d": np.array([self.delta % m for m in moduli], np.int64),
            "d_sh": np.array([_shoup(self.delta % m, m) for m in moduli], np.int64),
            "qhat": np.stack([mw.words_from_int(h, self.NWq) for h in crt.qhat]),
            "q_words": mw.words_from_int(q, self.W),
            "half_q": mw.words_from_int(q // 2, self.W),
            # words -> RNS: 2^(32w) mod q_j with its 32-bit Shoup companion
            "p32": np.array([[pow(2, 32 * w, m) for w in range(self.W)] for m in moduli],
                            np.int64),
            "p32_sh": np.array([[(pow(2, 32 * w, m) << 32) // m for w in range(self.W)]
                                for m in moduli], np.int64),
        }
        # the lift's sum is below L*q: its multiples j*q, j < L
        host["q_multiples"] = np.stack([mw.words_from_int(j * q, self.W)
                                        for j in range(self.L)])
        if self.supported:
            # centered remainder mod m = Δ^(l-1) (|a| <= q/2)
            self.mod_dpow = mw.StaticDivisor(dpow, q // 2)
            nw_m = self.mod_dpow.d_words.shape[-1]
            host["half_m"] = mw.words_from_int(dpow // 2, nw_m)
            host["m"] = self.mod_dpow.d_words
            # rounding division by 2Δ (numerator 2|a| + Δ <= q + Δ)
            self.div2d = mw.StaticDivisor(2 * self.delta, q + self.delta)
            host["delta_div"] = mw.words_from_int(self.delta, self.div2d.nw_in)
        self._host = host
        self._on = {}

    def tables(self, device) -> SimpleNamespace:
        """The plan's tables as int64 tensors on ``device``, uploaded at the
        first call for that device (the divisors' constants too)."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = SimpleNamespace(**{
                k: torch.as_tensor(v, device=device) for k, v in self._host.items()})
            if self.supported:
                self.mod_dpow.words(device)
                self.div2d.words(device)
        return self._on[device]

    def __hash__(self):
        return hash((self.moduli, self.ell, self.delta))

    def __eq__(self, other):
        return (isinstance(other, DecodePlan)
                and other.moduli == self.moduli and other.ell == self.ell
                and other.delta == self.delta)


@lru_cache(maxsize=32)
def _plan(moduli: tuple[int, ...], ell: int, delta: int) -> DecodePlan:
    return DecodePlan(moduli, ell, delta)


def get_plan(params) -> DecodePlan:
    return _plan(params.ring.moduli, params.l, params.delta())


def decode_supported(params) -> bool:
    """True when the device decode covers this parameter set (Δ >= 2 and
    Δ^(l-1) mod q in (0, q/2]: every practical PVW parameter set)."""
    return get_plan(params).supported


# --------------------------------------------------------------------------
# building blocks, vectorized over the message batch
# --------------------------------------------------------------------------

def _lift(t: SimpleNamespace, r: torch.Tensor, W: int) -> torch.Tensor:
    """CRT lift of residues r [d, L] -> canonical magnitude [d, W] in [0, q):
    sum_j ((r_j * qhat_inv_j) mod q_j) * qhat_j, the products of the 16-bit
    halves of each term with qhat's words summed over the limbs (each below
    L * 2^48). The sum is below L*q: it is compared with every multiple j*q
    at once, and the largest one it reaches is taken off (the JAX package
    subtracts 2^j * q conditionally, j from log2 L down)."""
    x = shoup_mul64_arr(r, t.qinv, t.qinv_sh, t.q)                  # [d, L], < q_j
    halves = mw._halves(torch.stack((x & mw.M32, x >> 32), -1))      # [d, L, 4]
    prod = (t.qhat.unsqueeze(-1) * halves.unsqueeze(-2)).sum(-3)     # [d, NWq, 4]
    acc = mw.acc_propagate(mw._lanes16(mw._skew_sum(prod)), W)
    k = mw.mag_ge(acc.unsqueeze(-2), t.q_multiples[1:]).sum(-1)      # floor(acc / q)
    return mw.mag_sub(acc, t.q_multiples[k])


def _center(t: SimpleNamespace, x: torch.Tensor):
    """Canonical [0, q) magnitude -> (|a|, neg) with the reference's STRICT
    > q/2 rule (``decryption.rs:140-152``)."""
    neg = mw.mag_gt(x, t.half_q)
    return mw.mag_select(neg, mw.mag_sub(t.q_words.expand_as(x), x), x), neg


def _sum_mod(r: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of r [..., n] (each < q) mod q, pairwise."""
    while r.shape[-1] > 1:
        h = r.shape[-1] // 2
        s = addmod(r[..., :h], r[..., h:2 * h], q)
        r = torch.cat((s, r[..., 2 * h:]), -1) if r.shape[-1] % 2 else s
    return r[..., 0]


def _words_to_rns(t: SimpleNamespace, mag: torch.Tensor, neg: torch.Tensor) -> torch.Tensor:
    """Sign-magnitude multiword mag [d, NWt], neg [d] -> canonical residues
    mod each q_j [d, L]: each word times 2^(32w) mod q_j (32-bit Shoup),
    summed mod q_j, negated where neg."""
    nw = mag.shape[-1]
    q = t.q.unsqueeze(-1)
    r = shoup_mul32_arr(mag.unsqueeze(-2), t.p32[:, :nw], t.p32_sh[:, :nw], q)
    acc = _sum_mod(r, q)                                              # [d, L]
    return torch.where(neg.unsqueeze(-1), negmod(acc, t.q), acc)


def _signed_add_mags(xm, xn, ym, yn):
    """Sign-magnitude add: (xm, xn) + (ym, yn) -> (mag, neg)."""
    same = xn == yn
    ge = mw.mag_ge(xm, ym)
    s_diff = mw.mag_select(ge, mw.mag_sub(xm, ym), mw.mag_sub(ym, xm))
    mag = mw.mag_select(same, mw.mag_add(xm, ym), s_diff)
    neg = torch.where(same | ge, xn, yn)
    return mag, neg & ~mw.mag_is_zero(mag)


# --------------------------------------------------------------------------
# the decode
# --------------------------------------------------------------------------

def decode_residues(plan: DecodePlan, res: torch.Tensor) -> torch.Tensor:
    """Decode PowerBasis residues int64 [d, L, l] (canonical) into the u64
    messages, int64 [d] of bit patterns, on ``res``'s device: the exact
    transcription of ``decode_scalar_pvw_rns`` batched over d. Counted in
    ``decode_residues.calls``."""
    if not plan.supported:
        raise ValueError("the device decode does not cover this parameter set "
                         "(decode_supported is False)")
    decode_residues.calls += 1
    t = plan.tables(res.device)
    W = plan.W
    q, qc = t.q, t.q.unsqueeze(-1)

    # tmp[i] = zc[i]*Δ - zc[i+1] mod q, in RNS       decryption.rs:19-27
    tmp = submod(shoup_mul64_arr(res[..., :-1], t.d.unsqueeze(-1), t.d_sh.unsqueeze(-1), qc),
                 res[..., 1:], qc)                                    # [d, L, l-1]
    # Horner fold mod q, in RNS                       decryption.rs:30-33
    last = tmp[..., 0]
    for i in range(1, plan.ell - 1):
        last = addmod(shoup_mul64_arr(last, t.d, t.d_sh, q), tmp[..., i], q)

    # centered remainder mod Δ^(l-1)                  decryption.rs:36-38
    a_mag, a_neg = _center(t, _lift(t, last, W))
    red = mw.mod_by_static(mw.fit(a_mag, plan.mod_dpow.nw_in), plan.mod_dpow)
    flip = mw.mag_gt(red, t.half_m)
    red_mag = mw.mag_select(flip, mw.mag_sub(t.m.expand_as(red), red), red)
    red_neg = torch.where(flip, ~a_neg, a_neg) & ~mw.mag_is_zero(red_mag)
    noise = _words_to_rns(t, red_mag, red_neg)                        # noise[l-1]

    # backward substitution, i = l-2 .. 0             decryption.rs:41-47
    for i in range(plan.ell - 2, -1, -1):
        an_mag, an_neg = _center(t, _lift(t, submod(noise, tmp[..., i], q), W))
        # (2|a| + Δ) / (2Δ), truncated; the sign follows a
        twice = mw.fit(mw.mag_add(an_mag, an_mag), plan.div2d.nw_in)
        quot_mag = mw.div_by_static(mw.mag_add(twice, t.delta_div.expand_as(twice)),
                                    plan.div2d)
        quot_neg = an_neg & ~mw.mag_is_zero(quot_mag)
        if i:
            noise = _words_to_rns(t, quot_mag, quot_neg)

    # plaintext = -(zc[0] + noise[0]) mod q, centered, clamped
    zc0_mag, zc0_neg = _center(t, _lift(t, res[..., 0], W))
    s_mag, s_neg = _signed_add_mags(zc0_mag, zc0_neg, mw.fit(quot_mag, W), quot_neg)
    qw = t.q_words.expand_as(s_mag)
    val = mw.mag_select(s_neg | mw.mag_is_zero(s_mag), s_mag, mw.mag_sub(qw, s_mag))
    # mf = center(val); when mf < 0 the wrapped value (mf + q) mod q is val
    # itself, and when mf >= 0 it is val too: the result is val's low 64
    # bits, zeroed for small negatives and for values that overflow u64
    # (decryption.rs:226-247)
    neg_mf = mw.mag_gt(val, t.half_q)
    mf_mag = mw.mag_select(neg_mf, mw.mag_sub(qw, val), val)
    small_neg = neg_mf & mw.mag_is_zero(mf_mag[..., 1:]) & (mf_mag[..., 0] <= 1000)
    zero_out = small_neg | ~mw.mag_is_zero(val[..., 2:])
    return torch.where(zero_out, 0, (val[..., 1] << 32) | val[..., 0])


decode_residues.calls = 0
