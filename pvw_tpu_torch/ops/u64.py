"""Exact modular arithmetic on int64 lanes.

The counterpart of ``pvw_tpu.ops.u64``. The JAX package keeps every
residue as a (hi, lo) pair of uint32 arrays because the TPU has no 64-bit
integer path. PyTorch has int64 on both the CPU and the GPU, and every
modulus of the scheme is below 2^62, so here a residue is ONE canonical
int64 in [0, q). Values that need all 64 bits (u64 scalars, Shoup
companions) are carried as their two's-complement bit pattern in an int64:
``+``, ``-`` and ``*`` on int64 wrap mod 2^64, which is exactly unsigned
arithmetic on the pattern. ``>>`` on int64 is arithmetic, so logical
shifts mask afterwards. (PyTorch on the CPU has no uint32 ``+ >> <<`` and
no unsigned 64-bit type, which is why the lanes are int64.)

All functions are elementwise tensor ops that broadcast, on any device.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)

NUM_DIGITS = 8
# int8-digit contraction headroom: 8 digit pairs * 128^2 * k must fit int32.
MAX_CONTRACTION = 8192


# --------------------------------------------------------------------------
# host <-> tensor conversion
# --------------------------------------------------------------------------

def as_i64(value: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bit pattern."""
    value = int(value)
    if not 0 <= value < 1 << 64:
        raise ValueError(f"{value} out of u64 range")
    return value - (1 << 64) if value >= 1 << 63 else value


def u64_tensor(arr, device="cpu") -> torch.Tensor:
    """numpy uint64 array -> int64 tensor holding the same bit patterns."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint64)).view(np.int64)
    return torch.from_numpy(a.copy()).to(device)


def u64_numpy(t: torch.Tensor) -> np.ndarray:
    """int64 tensor of u64 bit patterns -> numpy uint64 array."""
    return t.detach().to("cpu").contiguous().numpy().view(np.uint64)


# --------------------------------------------------------------------------
# wide products
# --------------------------------------------------------------------------

def mulhi64(a, b):
    """High 64 bits of the unsigned 64x64 product of two bit patterns,
    from four 32x32 partial products (PyTorch has no u64 mul-hi)."""
    a0, a1 = a & M32, (a >> 32) & M32
    b0, b1 = b & M32, (b >> 32) & M32
    ll = a0 * b0
    lh = a0 * b1
    hl = a1 * b0
    mid = ((ll >> 32) & M32) + (lh & M32) + (hl & M32)     # < 3 * 2^32
    return a1 * b1 + ((lh >> 32) & M32) + ((hl >> 32) & M32) + (mid >> 32)


def ult(a, b):
    """Unsigned a < b on int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


# --------------------------------------------------------------------------
# modular arithmetic (q < 2^62)
# --------------------------------------------------------------------------

def addmod(a, b, q):
    """(a + b) mod q for a, b in [0, q)."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def submod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    d = a - b
    return torch.where(d < 0, d + q, d)


def negmod(a, q):
    """(-a) mod q for a in [0, q)."""
    return torch.where(a == 0, a, q - a)


def shoup_mul64_arr(x, w, wp, q):
    """w * x mod q for any u64 pattern ``x``, constants w < q < 2^62 and
    w' = floor(w * 2^64 / q) (as its int64 pattern): Harvey's form of
    Shoup multiplication, one mulhi and one conditional subtract."""
    t = mulhi64(wp, x)
    r = w * x - t * q                      # in [0, 2q): exact mod 2^64
    return torch.where(r >= q, r - q, r)


def shoup_mul32_arr(x, w, wp32, q):
    """w * x mod q for x < 2^32 with the 32-bit companion
    w'32 = floor(w * 2^32 / q)."""
    t = (wp32 * x >> 32) & M32
    r = w * x - t * q
    return torch.where(r >= q, r - q, r)


# --------------------------------------------------------------------------
# signed 8-bit digits
# --------------------------------------------------------------------------

def digits_for_max(value: int) -> int:
    """Minimal digit count nd such that :func:`to_signed_digits` is exact
    for every input <= ``value`` (the top raw digit plus a carry stays
    below 128: ``value >> (8*(nd-1)) <= 126``)."""
    value = int(value)
    if not 0 <= value < 1 << 64:
        raise ValueError(f"{value} out of u64 range")
    nd = 1
    while (value >> (8 * (nd - 1))) > 126:
        nd += 1
    return min(nd, NUM_DIGITS)


def to_signed_digit_list(x, nd: int = NUM_DIGITS) -> list:
    """u64 patterns -> ``nd`` balanced signed digits (int8 tensors of the
    input shape) with x = sum d_i * 2^(8i). Exact whenever
    ``x >> (8*(nd-1)) <= 126`` (:func:`digits_for_max`); at nd=8 the final
    carry is dropped, so the digit sum is x read as a SIGNED i64 -- Rust's
    ``as i64`` (``encryption.rs:195``), which the gadget encode relies on."""
    out = []
    carry = torch.zeros_like(x)
    for i in range(nd):
        v = ((x >> (8 * i)) & 0xFF) + carry
        big = v >= 128
        out.append(torch.where(big, v - 256, v).to(torch.int8))
        carry = big.to(x.dtype)
    return out


def to_signed_digits(x, nd: int = NUM_DIGITS):
    """:func:`to_signed_digit_list` stacked on a trailing axis (int8)."""
    return torch.stack(to_signed_digit_list(x, nd), dim=-1)


# --------------------------------------------------------------------------
# exact column folds
# --------------------------------------------------------------------------

def _biased_groups(cols):
    """int32 columns [..., C] -> the biased u64 groups
    G_g = sum_{r<4} (M_{4g+r} + 2^31) << 8r  (each < 2^59)."""
    num_cols = cols.shape[-1]
    groups = []
    for g in range((num_cols + 3) // 4):
        acc = None
        for r in range(4):
            c = 4 * g + r
            if c >= num_cols:
                break
            uc = (cols[..., c].to(torch.int64) + (1 << 31)) << (8 * r)
            acc = uc if acc is None else acc + uc
        groups.append(acc)
    return groups


def fold_columns_grouped(cols, grp_w, grp_s, bias, q):
    """V = sum_c M_c * 2^(8c) mod q from int32 columns M_c, exactly.

    Biasing every column by 2^31 makes it unsigned; with
    K = sum_c 2^31 * 2^(8c) mod q, V + K = sum_g G_g * 2^(32g). Each group
    reduces with one Shoup multiply by w_g = 2^(32g) mod q, then K comes
    off once. ``grp_w``/``grp_s``: broadcastable tables with a trailing axis
    of w_g and its 64-bit Shoup companion; ``bias``: K; ``q``: the modulus,
    each broadcastable against ``cols.shape[:-1]``."""
    acc = None
    for g, gg in enumerate(_biased_groups(cols)):
        t = shoup_mul64_arr(gg, grp_w[..., g], grp_s[..., g], q)
        acc = t if acc is None else addmod(acc, t, q)
    return submod(acc, bias, q)


def fold_columns_words(cols, wrd_w, wrd_wp32, bias, q):
    """Same result as :func:`fold_columns_grouped`, by 32-bit words.

    Split each group G_g = gh_g * 2^32 + gl_g and regroup by weight:
    V + K = sum_w W_w * 2^(32w) with W_0 = gl_0 and
    W_w = gh_(w-1) + gl_w + carry. Words 1.. reduce with one 32-bit Shoup
    multiply by 2^(32w) mod q. REQUIRES q > 2^32 (W_0 < q), which
    ``RingPlan.fold_words_ok`` reports."""
    groups = _biased_groups(cols)
    ng = len(groups)
    acc = groups[0] & M32
    carry = 0
    for w in range(1, ng + 1):
        s = (groups[w - 1] >> 32) + (groups[w] & M32 if w < ng else 0) + carry
        carry = s >> 32
        t = shoup_mul32_arr(s & M32, wrd_w[..., w - 1], wrd_wp32[..., w - 1], q)
        acc = addmod(acc, t, q)
    return submod(acc, bias, q)
