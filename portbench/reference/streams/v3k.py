"""The program's ``noise_stream = "v3k"``: r from the global-counter cbd-k
stream, each product's noise from the global-counter v3k stream where its
bound has signed 8-bit digits (<= 32639), else from the row-keyed
bounded-uniform stream."""

from __future__ import annotations

import torch

from portbench.reference.pvw import M32, cbd_from_words, reduce96, row_uniform, threefry2x32


def randomness(k: torch.Tensor, rows, cols, l: int, variance: float):
    return v3k_cbd(k, rows, cols, l, variance)


def noise(k: torch.Tensor, rows, cols, l: int, bound: int):
    if bound <= 32639:
        return v3k_values(k, rows, cols, l, bound)
    return row_uniform(k, rows, cols, l, bound)


def v3k_values(k: torch.Tensor, rows, cols, l: int, bound: int):
    """v3k noise [R, C, l]: counters (g, ((c*(l/2) + jjp) << 2) | t); word t
    of coefficient 2 jjp is y0, of 2 jjp + 1 is y1."""
    k0, k1 = int(k[0]), int(k[1])
    rng = 2 * int(bound) + 1
    r = (rows & M32)[:, None]
    base = (cols & M32)[None, :] * (l // 2)
    out = torch.empty((len(rows), len(cols), l), dtype=torch.int64, device=rows.device)
    for jjp in range(l // 2):
        ws = [threefry2x32(k0, k1, r, (((base + jjp) << 2) | t) & M32) for t in range(3)]
        out[..., 2 * jjp] = reduce96(ws[0][0], ws[1][0], ws[2][0], rng) - bound
        out[..., 2 * jjp + 1] = reduce96(ws[0][1], ws[1][1], ws[2][1], rng) - bound
    return out


def v3k_cbd(k: torch.Tensor, rows, cols, l: int, variance: float):
    """cbd-k [R, C, l]: counters (g, ((c*l + j) << 2) | 3)."""
    k0, k1 = int(k[0]), int(k[1])
    r = (rows & M32)[:, None]
    c = (cols & M32)[None, :]
    out = torch.empty((len(rows), len(cols), l), dtype=torch.int64, device=rows.device)
    for j in range(l):
        w0, w1 = threefry2x32(k0, k1, r, (((c * l + j) << 2) | 3) & M32)
        out[..., j] = cbd_from_words(w0, w1, variance)
    return out
