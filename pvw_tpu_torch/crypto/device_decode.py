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

On a CUDA tensor :func:`decode_residues` launches one kernel
(``csrc/pvw_decode.cu``: a warp a message, the whole chain in registers),
counted in ``decode_residues.launches``; on a CPU tensor it runs the plain
twin :func:`decode_residues_plain`, in which the JAX package's ``lax.scan``
loops are Python loops over l. A plan's tables are built once on the host
(:func:`get_plan`) and moved to a device once (:meth:`DecodePlan.tables`;
the kernel's packed block :meth:`DecodePlan.kernel_tables`).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import mw
from ..ops._build import bind, count_launches, launch, ptr
from ..ops.u64 import addmod, as_i64, negmod, shoup_mul64_arr, shoup_mul32_arr, submod
from ..utils.intmath import CrtBasis

KERNEL = "pvw_decode"
#: The kernel's caps: limbs, ring degree and 32-bit words of a magnitude.
MAX_LIMBS, MAX_ELL, MAX_WORDS = 32, 32, 64


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

    def kernel_dims(self) -> tuple[int, ...]:
        """The kernel's sizes: L, l, W, the words of q, then (numerator
        words, words of R, words of D, quotient words) of the divisor
        Δ^(l-1) and of 2Δ."""
        return (self.L, self.ell, self.W, self.NWq,
                *(n for dv in (self.mod_dpow, self.div2d)
                  for n in (dv.fw, len(dv.r_words), len(dv.d_words), dv.nw_q)))

    def kernel_fits(self) -> bool:
        """True when the kernel's caps hold: L <= 32, 2 <= l <= 32, W <= 64."""
        return (self.L <= MAX_LIMBS and 2 <= self.ell <= MAX_ELL
                and self.W <= MAX_WORDS)

    def kernel_block(self) -> np.ndarray:
        """The tables of ``csrc/pvw_decode.cu`` packed into one int64
        block in the order of :func:`kernel_sections`, an entry a value (a
        multiword constant a 32-bit word an entry)."""
        h = {**self._host, "mod_r": self.mod_dpow.r_words, "mod_d": self.mod_dpow.d_words,
             "div_r": self.div2d.r_words, "div_d": self.div2d.d_words}
        return np.concatenate([np.asarray(h[name], np.int64).reshape(-1)
                               for name, _ in kernel_sections(self.kernel_dims())])

    def kernel_tables(self, device) -> torch.Tensor:
        """:meth:`kernel_block` as an int64 tensor on ``device``, uploaded
        at the first call for that device."""
        device = torch.device(device)
        key = (device, "kernel")
        if key not in self._on:
            self._on[key] = torch.as_tensor(self.kernel_block(), device=device)
        return self._on[key]

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


def kernel_sections(dims) -> list[tuple[str, tuple]]:
    """(name, shape) of each section of the kernel's table block, in the
    order its ``make_plan`` reads them, for :meth:`DecodePlan.kernel_dims`
    ``dims``: the plan's tables by their names, the divisors' R and D words
    as ``mod_r``, ``mod_d`` (Δ^(l-1)) and ``div_r``, ``div_d`` (2Δ)."""
    L, ell, W, nwq, m_fw, m_nr, m_nd, m_nq, v_fw, v_nr, v_nd, v_nq = dims
    return [("q", (L,)), ("qinv", (L,)), ("qinv_sh", (L,)), ("d", (L,)), ("d_sh", (L,)),
            ("p32", (L, W)), ("p32_sh", (L, W)), ("qhat", (L, nwq)), ("q_words", (W,)),
            ("half_q", (W,)), ("q_multiples", (L, W)), ("mod_r", (m_nr,)), ("mod_d", (m_nd,)),
            ("half_m", (m_nd,)), ("div_r", (v_nr,)), ("div_d", (v_nd,)),
            ("delta_div", (v_fw,))]


def split_kernel_block(dims, block) -> dict:
    """The sections of a packed table block (:meth:`DecodePlan.kernel_block`)
    by name, as int64 numpy arrays of their shapes. Raises unless the
    sections fill the block exactly."""
    block = np.asarray(block, np.int64)
    out, at = {}, 0
    for name, shape in kernel_sections(dims):
        size = int(np.prod(shape))
        out[name] = block[at:at + size].reshape(shape)
        at += size
    if at != block.size:
        raise ValueError(f"the block holds {block.size} entries, its sections {at}")
    return out


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

ENTRY = (KERNEL, "pvw_decode", [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p])


def decode_residues(plan: DecodePlan, res: torch.Tensor) -> torch.Tensor:
    """Decode PowerBasis residues int64 [d, L, l] (canonical) into the u64
    messages, int64 [d] of bit patterns, on ``res``'s device: a CUDA tensor
    launches ``csrc/pvw_decode.cu`` once on the current stream (counted in
    ``decode_residues.launches``; contiguous int64 [d, L, l] of the plan,
    within the kernel's caps, else it raises), a CPU tensor takes the plain
    twin :func:`decode_residues_plain`; anything else raises. Every call is
    counted in ``decode_residues.calls``."""
    if not plan.supported:
        raise ValueError("the device decode does not cover this parameter set "
                         "(decode_supported is False)")
    dev = res.device
    if dev.type == "cpu":
        decode_residues.calls += 1
        return decode_residues_plain(plan, res)
    if dev.type != "cuda":
        raise ValueError(f"decode_residues: unsupported device {dev}")
    if not plan.kernel_fits():
        raise ValueError(f"decode_residues: the kernel takes L <= {MAX_LIMBS}, 2 <= l <= "
                         f"{MAX_ELL} and W <= {MAX_WORDS} words, got L = {plan.L}, "
                         f"l = {plan.ell}, W = {plan.W}")
    if res.dtype != torch.int64 or res.dim() != 3 or tuple(res.shape[1:]) != \
            (plan.L, plan.ell) or not res.is_contiguous():
        raise ValueError(f"decode_residues: expected contiguous int64 [d, {plan.L}, "
                         f"{plan.ell}], got {res.dtype} {tuple(res.shape)}"
                         f"{'' if res.is_contiguous() else ', not contiguous'}")
    decode_residues.calls += 1
    d = res.shape[0]
    out = torch.empty(d, dtype=torch.int64, device=dev)
    if not d:
        return out
    tab = plan.kernel_tables(dev)
    dims = (ctypes.c_int * 12)(*plan.kernel_dims())
    launch(KERNEL, bind(*ENTRY), dev, ptr(res), d, dims, ptr(tab), tab.numel(), ptr(out))
    decode_residues.launches += 1
    return out


decode_residues.calls = 0
count_launches(KERNEL, decode_residues)


def decode_residues_plain(plan: DecodePlan, res: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_residues`, on ``res``'s
    device: the exact transcription of ``decode_scalar_pvw_rns`` batched
    over d, in tensor ops (no count)."""
    if not plan.supported:
        raise ValueError("the device decode does not cover this parameter set "
                         "(decode_supported is False)")
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
