"""Modular linear algebra over R_q by int8 digit products, in plain PyTorch.

The counterpart of ``pvw_tpu.ops.modmat``: residues are split into ``nd``
balanced signed 8-bit digits, the contraction runs over digits, and the
int32 digit-convolution columns fold back to residues exactly. These are
the plain versions the Hopper kernel is held against, and the torch code
of the parts of the path the JAX package left to XLA.

:func:`exact_int_matmul` is the one place that multiplies digit tensors.
PyTorch has no integer matmul on CUDA, so it runs the product in float64,
which is exact while every partial sum stays below 2^53: a contraction of
kd int8 digits is bounded by kd * 2^14, and the JAX package's column bound
kd * 2^14 < 2^31 is far inside that.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from . import u64 as u
from .u64 import MAX_CONTRACTION

if TYPE_CHECKING:
    from ..params.ring import RingPlan

# one intermediate tensor's budget; sizes the keygen party chunks
COLS_BYTES_BUDGET = 2 * 1024**3


def exact_int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer matmul of int8 digit tensors (broadcasting batch dims) ->
    int32, exact: float64 products and sums of int8 values are exact below
    2^53, and the result is below kd * 2^14 < 2^31 (checked)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError("exact_int_matmul takes int8 digit tensors")
    kd = a.shape[-1]
    if kd * (1 << 14) >= 1 << 31:
        raise ValueError(f"contraction {kd} exceeds int32 column headroom")
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.int32)


def digits(x, nd: int = u.NUM_DIGITS):
    """Residues [...] -> int8 digits [..., nd]."""
    return u.to_signed_digits(x, nd)


def _column_sums(p6, nd: int):
    """P [..., nd(i), m, nd(j), n] -> columns [..., m, n, 2nd-1],
    cols[c] = sum_{i+j=c} P[i, :, j, :]."""
    outs = []
    for c in range(2 * nd - 1):
        acc = None
        for i in range(max(0, c - (nd - 1)), min(nd - 1, c) + 1):
            term = p6[..., i, :, c - i, :]
            acc = term if acc is None else acc + term
        outs.append(acc)
    return torch.stack(outs, dim=-1)


def _fold_leading(cols, ring: "RingPlan"):
    """Fold int32 columns [L, ..., ncols] (limb axis leading) to residues
    [L, ...] with the grouped fold; the bias matches the actual column
    count."""
    dev = cols.device
    nmid = cols.ndim - 2
    shp = (ring.num_limbs,) + (1,) * nmid
    return u.fold_columns_grouped(
        cols,
        ring.table("grp_w", dev).reshape(shp + (4,)),
        ring.table("grp_s", dev).reshape(shp + (4,)),
        ring.table("bias_for_columns", dev, cols.shape[-1]).reshape(shp),
        ring.table("q", dev).reshape(shp),
    )


def matmul_channels(lhs, rhs, ring: "RingPlan"):
    """Modular matmul per (limb, slot) channel: lhs [L, S, m, k] and rhs
    [L, S, k, n] residues -> [L, S, m, n], by the nd x nd digit-product
    form (the right one for a skinny lhs, like decryption's m = 1)."""
    L, S, m, k = lhs.shape
    n = rhs.shape[-1]
    nd = ring.num_digits
    if k > MAX_CONTRACTION:
        raise ValueError(f"contraction {k} exceeds int32 headroom {MAX_CONTRACTION}")
    l2 = digits(lhs, nd).permute(0, 1, 4, 2, 3).reshape(L, S, nd * m, k)
    r2 = digits(rhs, nd).permute(0, 1, 2, 4, 3).reshape(L, S, k, nd * n)
    p = exact_int_matmul(l2, r2).reshape(L, S, nd, m, nd, n)
    return _fold_leading(_column_sums(p, nd), ring)


def lhs_digit_planes(x, ring: "RingPlan"):
    """Canonical residues [m, k, L, l] -> channel-major int8 digit planes
    [L, l, m, k*nd] (k-major, digit-minor): the encryption-invariant lhs
    of the fused scaled matmul."""
    m, k, L, l = x.shape
    return digits(x.permute(2, 3, 0, 1), ring.num_digits).reshape(L, l, m, k * ring.num_digits)


def operand_strides(x) -> list[int]:
    """The strides of every axis of ``x`` but the last; a size-1 axis, whose
    stride nothing reads, gets its dense value rounded up to 16."""
    st = list(x.stride())
    for i in range(x.dim() - 2, -1, -1):
        if x.shape[i] == 1:
            st[i] = -(-(st[i + 1] * x.shape[i + 1]) // 16) * 16
    return st[:-1]


def k_rows_ok(x) -> bool:
    """True when the int8 rows ``x`` [..., kd] lie as the Hopper kernels
    read them through TMA: k contiguous, every other stride and the base on
    16 bytes."""
    return (x.dtype == torch.int8 and (x.shape[-1] == 1 or x.stride(-1) == 1)
            and x.data_ptr() % 16 == 0 and all(s > 0 and s % 16 == 0
                                               for s in operand_strides(x)))


def k_rows(x):
    """int8 rows ``x`` [..., kd] laid out for the Hopper kernels
    (:func:`k_rows_ok`): ``x`` itself when they already are, else a copy
    into storage whose rows are zero-padded to a multiple of 16 bytes,
    returned as the view [..., :kd] (the same values)."""
    if k_rows_ok(x):
        return x
    kd = x.shape[-1]
    store = torch.zeros((*x.shape[:-1], -(-kd // 16) * 16), dtype=torch.int8, device=x.device)
    store[..., :kd] = x
    return store[..., :kd]


def _scaled_digits(x, ring: "RingPlan", shp):
    """Yields, for i < nd, the digit list of x * 2^(8i) mod q (residues x;
    ``shp`` broadcasts the per-limb constants against x)."""
    dev = x.device
    q = ring.table("q", dev).reshape(shp)
    for i in range(ring.num_digits):
        t = x if i == 0 else u.shoup_mul64_arr(
            x, ring.table("pow_w", dev)[:, i].reshape(shp),
            ring.table("pow_s64", dev)[:, i].reshape(shp), q)
        yield u.to_signed_digit_list(t, ring.num_digits)


def lhs_scaled_planes(x, ring: "RingPlan"):
    """Canonical residues [m, k, L, l] -> scaled channel-major digit planes
    int8 [L, l, nd(c), m, k*nd(i)], entry (c, mm, kk*nd + i) =
    digit_c(x[mm, kk] * 2^(8i) mod q): the cached lhs of the swapped fused
    matmul (the Shoup scales on the encryption-invariant side, nd times the
    plain planes' bytes)."""
    m, k, L, l = x.shape
    nd = ring.num_digits
    out = torch.empty((L, l, nd, m, k, nd), dtype=torch.int8, device=x.device)
    for i, digs in enumerate(_scaled_digits(x.permute(2, 3, 0, 1), ring, (L, 1, 1, 1))):
        for c, d in enumerate(digs):
            out[:, :, c, :, :, i] = d
    return out.reshape(L, l, nd, m, k * nd)


def rhs_digit_cols(rhs_ch, ring: "RingPlan"):
    """Channel-major residues [L, l, k, n] -> plain digit rows int8
    [L, l, k*nd(i), n] (k-major, digit-minor, the column order of
    :func:`lhs_scaled_planes`): the per-encryption rhs of the swapped
    form, nd digit extractions and no Shoup scales. Laid out k-packed, as
    the swapped kernel reads it: storage [L, l, n, kd_pad] (kd_pad = k*nd
    rounded up to 16, the pads zero) returned as the strided view
    [L, l, k*nd, n]."""
    L, l, k, n = rhs_ch.shape
    nd = ring.num_digits
    kd = k * nd
    store = torch.empty((L, l, n, -(-kd // 16) * 16), dtype=torch.int8, device=rhs_ch.device)
    store[..., kd:] = 0
    out = store[..., :kd].view(L, l, n, k, nd)                    # (nn, kk, i)
    for i, d in enumerate(u.to_signed_digit_list(rhs_ch, nd)):
        out[..., i] = d.transpose(-1, -2)
    return store[..., :kd].transpose(-1, -2)


def prescale_digits_band(rhs, ring: "RingPlan"):
    """Scaled-digit band of the small operand: residues [L, S, k, n] ->
    int8 [L, S, nd(j), k*nd(i), n], entry (j, kk*nd + i, nn) = digit j of
    rhs[kk, nn] * 2^(8i) mod q. Contracting lhs digits over (k, i) against
    it gives only nd columns: sum_k a*b = sum_j 2^(8j) sum_{k,i} a_i t_ij.
    Laid out k-packed, as kernel 4 writes it and the Hopper kernels read
    it: storage [L, S, nd, n, kd_pad] (kd_pad = k*nd rounded up to 16, the
    pads zero) returned as the strided view [L, S, nd, k*nd, n]."""
    L, S, k, n = rhs.shape
    nd = ring.num_digits
    kd = k * nd
    store = torch.empty((L, S, nd, n, -(-kd // 16) * 16), dtype=torch.int8, device=rhs.device)
    store[..., kd:] = 0
    out = store[..., :kd].view(L, S, nd, n, k, nd)                # (j, nn, kk, i)
    for i, digs in enumerate(_scaled_digits(rhs, ring, (L,) + (1,) * (rhs.ndim - 1))):
        for j, d in enumerate(digs):
            out[:, :, j, :, :, i] = d.transpose(-1, -2)
    return store[..., :kd].transpose(-1, -2)


def scaled_cols(lhs, band, ring: "RingPlan", lhs_dig=None):
    """Digit matmul against a scaled band: lhs residues [L, S, m, k] (or
    its digit planes ``lhs_dig`` [L, S, m, k*nd]) and ``band`` from
    :func:`prescale_digits_band` -> int32 columns [L, S, m, n, nd], each
    bounded by k*nd*2^14."""
    nd = ring.num_digits
    if lhs_dig is None:
        L, S, m, k = lhs.shape
        lhs_dig = digits(lhs, nd).reshape(L, S, m, k * nd)
    if lhs_dig.shape[-1] // nd > MAX_CONTRACTION:
        raise ValueError(f"contraction exceeds int32 headroom {MAX_CONTRACTION}")
    L, S, _, kd, n = band.shape
    r2 = band.permute(0, 1, 3, 2, 4).reshape(L, S, kd, nd * n)     # (k,i) x (j,n)
    p = exact_int_matmul(lhs_dig, r2)                               # [L, S, m, nd*n]
    return p.reshape(L, S, -1, nd, n).permute(0, 1, 2, 4, 3)


def from_signed_coeffs(coeffs, ring: "RingPlan"):
    """Signed integer coefficients [..., l] -> residues [..., L, l]
    (negatives wrap per modulus, ``secret_key.rs:76``)."""
    c = torch.as_tensor(coeffs).to(torch.int64)
    q = ring.table("q", c.device)[:, None]
    return torch.remainder(c[..., None, :], q)


def _q(ring: "RingPlan", device):
    return ring.table("q", device)[:, None]


def poly_add(a, b, ring: "RingPlan"):
    """(a + b) mod q on [..., L, l] residues."""
    return u.addmod(a, b, _q(ring, a.device))


def poly_sub(a, b, ring: "RingPlan"):
    return u.submod(a, b, _q(ring, a.device))


def poly_neg(a, ring: "RingPlan"):
    return u.negmod(a, _q(ring, a.device))


def poly_pointwise_mul(a, b, ring: "RingPlan"):
    """Elementwise a*b mod q on [..., L, l] residues (the NTT-domain ring
    product): the nd x nd digit products, their 2nd-1 columns, the fold."""
    nd = ring.num_digits
    p = digits(a, nd).to(torch.int32)[..., :, None] * digits(b, nd).to(torch.int32)[..., None, :]
    cols = torch.stack([sum(p[..., i, c - i] for i in range(max(0, c - nd + 1), min(nd - 1, c) + 1))
                        for c in range(2 * nd - 1)], dim=-1)        # [..., L, l, 2nd-1]
    return _fold_leading(cols.movedim(-3, 0), ring).movedim(0, -2)


def poly_matmul(a, b, ring: "RingPlan"):
    """R_q matrix product in the canonical layout: a [m, k, L, l] and b
    [k, n, L, l], both NTT, -> [m, n, L, l] (the shape of ``crs.rs:152-168``
    and ``encryption.rs:185-192``), by :func:`matmul_channels`; the JAX
    package picks its banded form for m >= k, which gives the same
    residues."""
    out = matmul_channels(a.permute(2, 3, 0, 1), b.permute(2, 3, 0, 1), ring)
    return out.permute(2, 3, 0, 1)
