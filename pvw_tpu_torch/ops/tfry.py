"""Threefry-2x32-20 on int64 lanes and the "stream v3k" contract.

The counterpart of ``pvw_tpu.ops.tfry``. Words are int64 tensors holding
values in [0, 2^32); every add masks back to 32 bits. The v3k counters are
the value's GLOBAL coordinates: for the noise value at (row g, column c,
coefficient jj = 2*jjp + parity) and draw word t in {0, 1, 2},

    (y0, y1) = Threefry-2x32-20(key, (g, ((c*(l/2) + jjp) << 2) | t))

word t of coefficient 2*jjp is y0, of 2*jjp+1 is y1, and the value is the
exact 96-bit reduction floor(x96 * (2*bound+1) / 2^96) - bound. The cbd-k
r stream uses counters (g, ((c*l + jj) << 2) | 3).
"""

from __future__ import annotations

import torch

from .u64 import M32

_PARITY = 0x1BD11BDA
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on int64 words < 2^32 (broadcasting; the
    key words may be Python ints). Bit-identical to JAX's
    ``threefry_2x32`` for the same (key, counter) words."""
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    schedule = ((k1, ks2, 1), (ks2, k0, 2), (k0, k1, 3),
                (k1, ks2, 4), (ks2, k0, 5))
    for i, (ka, kb, inc) in enumerate(schedule):
        for r in (_ROT_A if i % 2 == 0 else _ROT_B):
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ka) & M32
        x1 = (x1 + kb + inc) & M32
    return x0, x1


def reduce96(b_hi, b_mid, b_lo, rng: int):
    """floor(x96 * rng / 2^96) for x96 = b_hi*2^64 + b_mid*2^32 + b_lo and
    rng < 2^31: exact, by three carries of 32-bit partial products (each
    below 2^63)."""
    t = (b_lo * rng) >> 32
    t = (b_mid * rng + t) >> 32
    return (b_hi * rng + t) >> 32


def key_words(key) -> tuple[int, int]:
    """(k0, k1) Python ints of a key tensor [2]."""
    return int(key[0]), int(key[1])


def _coords(row_off, rows, col_off, cols, device):
    r = (row_off + torch.arange(rows, dtype=torch.int64, device=device))[:, None]
    c = (col_off + torch.arange(cols, dtype=torch.int64, device=device))[None, :]
    return r & M32, c & M32


def v3k_values(k0, k1, row_off, rows: int, cols: int, l: int, bound: int,
               col_off=0, device="cpu"):
    """Signed int32 noise values [rows, cols, l] of the v3k stream for
    global rows [row_off, row_off+rows) and columns [col_off, col_off+cols)."""
    if l % 2:
        raise ValueError("v3k requires even ring degree")
    r, c = _coords(row_off, rows, col_off, cols, device)
    rng = 2 * int(bound) + 1
    base = c * (l // 2)
    out = torch.empty((rows, cols, l), dtype=torch.int32, device=device)
    for jjp in range(l // 2):
        ws = [threefry2x32(k0, k1, r, (((base + jjp) << 2) | t) & M32)
              for t in range(3)]
        out[..., 2 * jjp] = (reduce96(ws[0][0], ws[1][0], ws[2][0], rng) - bound).to(torch.int32)
        out[..., 2 * jjp + 1] = (reduce96(ws[0][1], ws[1][1], ws[2][1], rng) - bound).to(torch.int32)
    return out


def v3k_noise_digit_planes(k0, k1, row_off, rows: int, cols: int, l: int,
                           bound: int, col_off=0, device="cpu"):
    """v3k noise as int8 signed digit planes [l*jr, rows, cols] (row
    j*jr+dd for coefficient j, digit dd), or None when the bound exceeds
    the signed-digit range."""
    from .ntt import _digit_planes, signed_digit_count

    jr = signed_digit_count(bound)
    if not jr:
        return None
    out = torch.empty((l * jr, rows, cols), dtype=torch.int8, device=device)
    step = max(1, (1 << 22) // max(1, cols * l))
    for r0 in range(0, rows, step):
        r1 = min(rows, r0 + step)
        vals = v3k_values(k0, k1, row_off + r0, r1 - r0, cols, l, bound,
                          col_off, device)
        out[:, r0:r1] = _digit_planes(vals, jr)
    return out


def popcount32(x):
    """Set bits of int64 words < 2^32 (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def cbd_from_words(w0, w1, variance: float):
    """The CBD value of two 32-bit words, ``sample_vec_cbd``'s
    construction: b1 - b2 at variance 0.5, else the popcount of 2v bits
    minus the popcount of the next 2v bits."""
    if abs(float(variance) - 0.5) < 1e-6:
        return ((w0 & 1) - (w1 & 1)).to(torch.int32)
    two_v = 2 * int(variance)
    mask = (1 << two_v) - 1 if two_v < 32 else M32
    add = popcount32(w0 & mask)
    if 2 * two_v <= 32:
        sub = popcount32((w0 >> two_v) & mask)
    else:
        low_avail = 32 - two_v
        sub = popcount32(w0 >> two_v) + popcount32(w1 & ((1 << (two_v - low_avail)) - 1))
    return (add - sub).to(torch.int32)


def v3k_cbd_values(k0, k1, row_off, rows: int, cols: int, l: int,
                   variance: float, col_off=0, device="cpu"):
    """Global-counter CBD ("cbd-k"), the r stream of v3k: int32
    [rows, cols, l], one threefry evaluation per sample on counters
    (row, ((col*l + jj) << 2) | 3)."""
    from ..sampling.cbd import _check_variance

    _check_variance(variance)
    if l % 2:
        raise ValueError("v3k requires even ring degree")
    r, c = _coords(row_off, rows, col_off, cols, device)
    out = torch.empty((rows, cols, l), dtype=torch.int32, device=device)
    for jj in range(l):
        w0, w1 = threefry2x32(k0, k1, r, (((c * l + jj) << 2) | 3) & M32)
        out[..., jj] = cbd_from_words(w0, w1, variance)
    return out
