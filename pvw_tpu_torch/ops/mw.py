"""Exact multiword unsigned arithmetic for the device decode.

The counterpart of ``pvw_tpu.ops.mw``. A magnitude is an int64 tensor
``[..., NW]`` with a trailing little-endian word axis; each lane holds one
32-bit word (0 <= w < 2^32). The lanes are int64 because torch on the CPU
has no uint32 arithmetic, as in :mod:`pvw_tpu_torch.ops.u64`. Every
function is a shape-polymorphic tensor op that broadcasts over the leading
batch dims, on any device, with the same results as the JAX package's.

Signed lanes set two rules:

- **Products.** A product of two 32-bit words reaches 2^64 - 2^33 + 1,
  which overflows int64 (and ``>>`` of a negative int64 is arithmetic).
  So one factor is always split into 16-bit halves first: every partial
  product is below 2^48, and every column sum below 2^55.
- **Accumulators.** Where the JAX package keeps a carry-save pair (h, l)
  of uint32 per word position, an accumulator here is ONE int64 lane per
  position holding the plain sum of that position's contributions.
  Callers keep each lane below 2^63 (at most 2^15 contributions below
  2^48 a lane); :func:`acc_propagate` resolves the lanes into words.

Carries are not rippled word by word. The per-word carry-generate and
carry-propagate flags (mutually exclusive) are packed into one int64
bitmask each, 62 words a mask, and one integer addition resolves every
carry of the chain at once: with G the generate mask, P the propagate
mask and c_in the carry into word 0, the carry into word w is bit w of
``(G + (G | P) + c_in) ^ P`` (a binary adder has exactly this
generate/propagate structure), and bit 62 carries on into the next
62 words. Comparisons pack the word-wise ``>`` and ``<`` flags the same
way: the larger mask decides. So an add, a subtract or a compare is a
fixed handful of tensor ops whatever the width.

Division by the decode's static constants uses a host-precomputed
reciprocal (:class:`StaticDivisor`): an estimate at most one below the
quotient, corrected by one conditional step, as in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
M16 = 0xFFFF
# words whose flags share one int64 mask, leaving bit 62 for the carry out
CHUNK = 62


# --------------------------------------------------------------------------
# host helpers
# --------------------------------------------------------------------------

def words_from_int(value: int, nw: int) -> np.ndarray:
    """Python int >= 0 -> int64[nw] little-endian 32-bit words (checked fit)."""
    if value < 0:
        raise ValueError("magnitude must be non-negative")
    v = int(value)
    out = np.zeros(nw, np.int64)
    for i in range(nw):
        out[i] = v & M32
        v >>= 32
    if v:
        raise OverflowError(f"value needs more than {nw} words")
    return out


def int_from_words(words) -> int:
    """Words [NW] (numpy or tensor) -> Python int (host, for tests)."""
    if torch.is_tensor(words):
        words = words.detach().cpu().numpy()
    acc = 0
    for w in reversed(np.asarray(words).reshape(-1).tolist()):
        acc = (acc << 32) | (int(w) & M32)
    return acc


def nw_for_bits(bits: int) -> int:
    """Word count holding any value below 2^bits."""
    return max(1, (int(bits) + 31) // 32)


def _fit(words: np.ndarray, nw: int) -> np.ndarray:
    """Host words padded with zero words or cut to ``nw`` (raises if a cut
    word is not zero)."""
    words = np.asarray(words, np.int64)
    if words.shape[-1] >= nw:
        if np.any(words[..., nw:]):
            raise OverflowError("static constant wider than target")
        return words[..., :nw]
    return np.pad(words, [(0, 0)] * (words.ndim - 1) + [(0, nw - words.shape[-1])])


def as_words(words, like: torch.Tensor) -> torch.Tensor:
    """``words`` (host numpy or a tensor) as an int64 tensor on ``like``'s
    device; a tensor already there is returned as it is (no copy)."""
    if torch.is_tensor(words):
        return words.to(like.device)
    return torch.as_tensor(np.asarray(words, np.int64), device=like.device)


def fit(x: torch.Tensor, nw: int) -> torch.Tensor:
    """Words ``x`` [..., n] zero-padded or cut to ``nw`` (a cut keeps the
    value mod 2^(32 nw))."""
    n = x.shape[-1]
    if n < nw:
        return F.pad(x, (0, nw - n))
    return x[..., :nw]


# --------------------------------------------------------------------------
# carry resolution
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bit_index(device: torch.device) -> torch.Tensor:
    return torch.arange(CHUNK, dtype=torch.int64, device=device)


@functools.lru_cache(maxsize=None)
def _bit_value(device: torch.device) -> torch.Tensor:
    return torch.ones(CHUNK, dtype=torch.int64, device=device) << _bit_index(device)


def _pack(flags: torch.Tensor) -> torch.Tensor:
    """Flags (bool or 0/1) [..., n <= 62] -> int64 bitmask [...], bit w =
    flag w."""
    return (flags * _bit_value(flags.device)[:flags.shape[-1]]).sum(-1)


def _carries(gen: torch.Tensor, prop: torch.Tensor, cin=None):
    """Carry chain c_0 = ``cin``, c_(w+1) = gen_w | (prop_w & c_w) for
    exclusive flags [..., n]: (the carries into each word and the carry
    out of the top word, int64 0/1 [..., n] and [...])."""
    n = gen.shape[-1]
    carry = 0 if cin is None else cin
    outs = []
    for lo in range(0, n, CHUNK):
        width = min(CHUNK, n - lo)
        g = _pack(gen[..., lo:lo + width])
        p = _pack(prop[..., lo:lo + width])
        s = g + (g | p) + carry
        bits = _bit_index(gen.device)[:width]
        outs.append(((s ^ p).unsqueeze(-1) >> bits) & 1)
        carry = (s >> width) & 1
    return (outs[0] if len(outs) == 1 else torch.cat(outs, -1)), carry


def _order(x: torch.Tensor, y: torch.Tensor):
    """(x > y, x < y) of two magnitudes of one width, as bool [...]: the
    word flags packed into masks, most significant word highest, so the
    larger mask holds the top differing word."""
    gt, lt = x > y, x < y
    while gt.shape[-1] > 1:
        starts = range(0, gt.shape[-1], CHUNK)
        g = torch.stack([_pack(gt[..., s:s + CHUNK]) for s in starts], -1)
        l_ = torch.stack([_pack(lt[..., s:s + CHUNK]) for s in starts], -1)
        gt, lt = g > l_, g < l_
    return gt[..., 0], lt[..., 0]


# --------------------------------------------------------------------------
# accumulator: one int64 lane per word position
# --------------------------------------------------------------------------

def acc_zero(shape: tuple, npos: int, device="cpu") -> torch.Tensor:
    return torch.zeros(tuple(shape) + (npos,), dtype=torch.int64, device=device)


def _place(v: torch.Tensor, offset: int, npos: int) -> torch.Tensor:
    return F.pad(v, (offset, npos - offset - v.shape[-1]))


def acc_add_u32(acc: torch.Tensor, contrib: torch.Tensor, offset: int) -> torch.Tensor:
    """Add 32-bit word contributions [..., NWc] at word position ``offset``."""
    return acc + _place(contrib, offset, acc.shape[-1])


def acc_add_sum32(acc: torch.Tensor, lo16_sum, hi16_sum, offset: int) -> torch.Tensor:
    """Add per-position sums of 16-bit halves (each < 2^31) at word
    position ``offset``: the sum of many words split into their halves,
    each half summed exactly, folded in here as lo + hi * 2^16 (< 2^48)."""
    v = lo16_sum.to(torch.int64) + (hi16_sum.to(torch.int64) << 16)
    return acc + _place(v, offset, acc.shape[-1])


def acc_propagate(acc: torch.Tensor, nw_out: int) -> torch.Tensor:
    """Resolve the lanes (each < 2^63) into normalized words [..., nw_out],
    the value mod 2^(32 nw_out). Two passes move each lane's high part one
    word up (after them every lane is at most 2^32, so at most one carry
    a word); the carries then resolve at once."""
    lanes = fit(acc, nw_out)
    for _ in range(2):
        high = lanes[..., :-1] >> 32
        lanes = lanes & M32
        lanes[..., 1:].add_(high)
    words = lanes & M32
    c, _ = _carries(lanes >> 32, words == M32)
    return (words + c) & M32


# --------------------------------------------------------------------------
# normalized-magnitude ops
# --------------------------------------------------------------------------

def mag_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x + y, same width, mod 2^(32 NW) (callers keep it from overflowing)."""
    s = x + y
    words = s & M32
    c, _ = _carries(s >> 32, words == M32)
    return (words + c) & M32


def _sub(x: torch.Tensor, y: torch.Tensor):
    """((x - y) mod 2^(32 NW), the final borrow as int64 0/1)."""
    s = x - y
    words = s & M32
    b, out = _carries(s < 0, words == 0)
    return (words - b) & M32, out


def mag_sub_borrow(x: torch.Tensor, y: torch.Tensor):
    """((x - y) mod 2^(32 NW), the final borrow: x < y)."""
    d, out = _sub(x, y)
    return d, out.bool()


def mag_sub(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x - y for x >= y (unchecked)."""
    return _sub(x, y)[0]


def mag_ge(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Boolean x >= y (same width)."""
    return ~_order(x, y)[1]


def mag_gt(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Boolean x > y (same width)."""
    return _order(x, y)[0]


def mag_is_zero(x: torch.Tensor) -> torch.Tensor:
    return (x == 0).all(-1)


def mag_select(pred: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise pred ? a : b on magnitudes; pred has the batch shape."""
    return torch.where(pred.unsqueeze(-1), a, b)


def mag_cond_sub(x: torch.Tensor, m_words) -> torch.Tensor:
    """Subtract the constant m once if x >= m; ``m_words`` host words (fit
    to x's width here) or a tensor of x's width."""
    if not torch.is_tensor(m_words):
        m_words = _fit(m_words, x.shape[-1])
    d, borrow = mag_sub_borrow(x, as_words(m_words, x))
    return torch.where(borrow.unsqueeze(-1), x, d)


def mag_inc(x: torch.Tensor, pred: torch.Tensor) -> torch.Tensor:
    """x + (pred ? 1 : 0), mod 2^(32 NW)."""
    c, _ = _carries(torch.zeros_like(x, dtype=torch.bool), x == M32, pred)
    return (x + c) & M32


def mag_truncate(x: torch.Tensor, nw: int) -> torch.Tensor:
    return x[..., :nw]


# --------------------------------------------------------------------------
# products
# --------------------------------------------------------------------------

def _halves(x: torch.Tensor) -> torch.Tensor:
    """Words [..., n] -> their 16-bit halves [..., 2n], little-endian."""
    return torch.stack((x & M16, x >> 16), -1).flatten(-2)


def _skew_sum(prod: torch.Tensor) -> torch.Tensor:
    """Partial products [..., n, m], row i at word i (16-bit unit 2i) and
    column j at 16-bit unit j -> the sums of each 16-bit unit [..., m+2n-2]:
    each row padded to m + 2n and the rows read back at width m + 2n - 2,
    which shifts row i right by 2i."""
    *lead, n, m = prod.shape
    if n == 1:
        return prod[..., 0, :]
    flat = F.pad(prod, (0, 2 * n)).reshape(*lead, n * (m + 2 * n))
    return flat[..., :n * (m + 2 * n - 2)].reshape(*lead, n, m + 2 * n - 2).sum(-2)


def _lanes16(cols: torch.Tensor) -> torch.Tensor:
    """Sums at 16-bit units [..., m] -> accumulator lanes at 32-bit words
    [..., ceil(m/2) + 1]: an odd unit's low 16 bits go up into its word,
    the rest into the next word (no lane reaches 2^63)."""
    if cols.shape[-1] % 2:
        cols = F.pad(cols, (0, 1))
    even, odd = cols[..., 0::2], cols[..., 1::2]
    lanes = F.pad(even + ((odd & M16) << 16), (0, 1))
    lanes[..., 1:].add_(odd >> 16)
    return lanes


def _product(a: torch.Tensor, b: torch.Tensor, nw_out: int) -> torch.Tensor:
    """a [..., na] * b [..., nb] (words, leading dims broadcast) ->
    normalized [..., nw_out], mod 2^(32 nw_out). The narrower factor gives
    the rows, the other its 16-bit halves: every product < 2^48."""
    if a.shape[-1] > b.shape[-1]:
        a, b = b, a
    prod = a.unsqueeze(-1) * _halves(b).unsqueeze(-2)
    return acc_propagate(_lanes16(_skew_sum(prod)), nw_out)


def mag_mul_static(x: torch.Tensor, r_words) -> torch.Tensor:
    """x [..., NWx] * a constant (host words or a tensor [NWr]) ->
    [..., NWx + NWr]."""
    r = as_words(r_words, x)
    return _product(x, r, x.shape[-1] + r.shape[-1])


def mag_mul_u64pair(x: torch.Tensor, y_hi: torch.Tensor, y_lo: torch.Tensor) -> torch.Tensor:
    """x [..., NW] * a u64 per element, given as its 32-bit words (y_hi,
    y_lo) -> [..., NW + 2]."""
    return _product(x, torch.stack((y_lo, y_hi), -1), x.shape[-1] + 2)


# --------------------------------------------------------------------------
# division and remainder by static constants
# --------------------------------------------------------------------------

class StaticDivisor:
    """Host-precomputed reciprocal plan for floor-division by a fixed D.

    For inputs num < 2^(32*fw): R = floor(2^F / D) with F = 32*fw, then
    t = floor(num * R / 2^F) satisfies floor(num/D) - 1 <= t <= floor(num/D),
    so one conditional correction step makes both the quotient and the
    remainder exact. The constants' words go to a device once
    (:meth:`words`)."""

    def __init__(self, d: int, max_value: int) -> None:
        if d <= 0:
            raise ValueError("divisor must be positive")
        self.d = int(d)
        bits = max(int(max_value).bit_length() + 1, 33)
        self.fw = (bits + 31) // 32
        r = (1 << (32 * self.fw)) // self.d
        self.r_words = words_from_int(r, nw_for_bits(r.bit_length()))
        self.d_words = words_from_int(self.d, nw_for_bits(self.d.bit_length()))
        self.nw_in = self.fw                      # num must fit fw words
        # the quotient fits max_value // d
        self.nw_q = nw_for_bits((int(max_value) // self.d).bit_length() or 1)
        self._on = {}

    def words(self, device) -> tuple:
        """(R, D, D at the input width) as int64 tensors on ``device``,
        uploaded at the first call for that device."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = tuple(
                torch.as_tensor(w, device=device)
                for w in (self.r_words, self.d_words, _fit(self.d_words, self.nw_in)))
        return self._on[device]


def _reciprocal_step(num: torch.Tensor, plan: StaticDivisor):
    """(num at the plan's width, t, num - t*D) with t the reciprocal's
    estimate of floor(num / D)."""
    nw = num.shape[-1]
    if nw > plan.nw_in:
        raise ValueError("numerator wider than the divisor plan allows")
    num = fit(num, plan.nw_in)
    r, d, d_full = plan.words(num.device)
    t = mag_mul_static(num, r)[..., plan.fw:]
    td = mag_mul_static(t, d)[..., :plan.nw_in]
    return t, mag_sub(num, td), d_full


def div_by_static(num: torch.Tensor, plan: StaticDivisor) -> torch.Tensor:
    """floor(num / D) exactly; num [..., nw] with nw <= plan.nw_in words and
    value < 2^(32*plan.nw_in). Returns [..., plan.nw_q]."""
    t, r, d_full = _reciprocal_step(num, plan)
    return mag_inc(t, mag_ge(r, d_full))[..., :plan.nw_q]


def mod_by_static(num: torch.Tensor, plan: StaticDivisor) -> torch.Tensor:
    """num mod D exactly (same contract as :func:`div_by_static`).
    Returns [..., len(plan.d_words)]."""
    _, r, d_full = _reciprocal_step(num, plan)
    return mag_cond_sub(r, d_full)[..., :plan.d_words.shape[-1]]
