"""Negacyclic NTT for small ring degrees, as digit matmuls.

The counterpart of ``pvw_tpu.ops.ntt``. The degree l is 8..32, so the NTT
is a dense l x l twiddle product per limb, run through the same int8 digit
contraction and exact fold as every other product:

    forward:  y[j] = sum_i x[i] * psi^(i*(2j+1))
    inverse:  x[i] = l^{-1} * sum_j y[j] * psi^(-i*(2j+1))
"""

from __future__ import annotations

import math
from typing import TYPE_CHECKING

import torch

from .modmat import _fold_leading, digits, exact_int_matmul

if TYPE_CHECKING:
    from ..params.ring import RingPlan


def _matrix_cols(x, band_name: str, ring: "RingPlan"):
    """x: residues [..., L, l] -> unfolded columns int32 [L, l, B, C] and
    the batch shape, from one digit matmul per limb against the banded
    twiddles ``band_name`` ([L, C*l, nd*l])."""
    batch_shape = tuple(x.shape[:-2])
    L, l, nd, C = ring.num_limbs, ring.degree, ring.num_digits, ring.num_columns
    b = math.prod(batch_shape)
    xd = digits(x.reshape(b, L, l).permute(1, 2, 0), nd)       # [L, l, B, nd]
    rhs = xd.permute(0, 1, 3, 2).reshape(L, l * nd, b)
    band = ring.table(band_name, x.device)
    p = exact_int_matmul(band, rhs)                             # [L, C*l, B]
    return p.reshape(L, C, l, b).permute(0, 2, 3, 1), batch_shape


def _apply_matrix(x, band_name: str, ring: "RingPlan"):
    cols, batch_shape = _matrix_cols(x, band_name, ring)
    out = _fold_leading(cols, ring)                             # [L, l, B]
    return out.permute(2, 0, 1).reshape(batch_shape + (ring.num_limbs, ring.degree))


def ntt_forward(x, ring: "RingPlan"):
    """PowerBasis -> Ntt on [..., L, l] residues."""
    return _apply_matrix(x, "ntt_fwd_band", ring)


def ntt_inverse(x, ring: "RingPlan"):
    """Ntt -> PowerBasis on [..., L, l] residues."""
    return _apply_matrix(x, "ntt_inv_band", ring)


# --------------------------------------------------------------------------
# small-coefficient path: NTT straight from signed integer coefficients
# --------------------------------------------------------------------------

def signed_digit_count(max_abs: int) -> int:
    """Signed 8-bit digits needed for |v| <= max_abs: 1, 2, or 0 (too big
    for the small path)."""
    if max_abs <= 127:
        return 1
    if max_abs <= 32639:  # 127*256 + 127
        return 2
    return 0


def _signed_digits(c, jr: int):
    """int32 values [..., l] -> int8 digits [..., l, jr] (balanced; exact
    for |v| <= 127 (jr=1) / 32639 (jr=2))."""
    c = c.to(torch.int32)
    if jr == 1:
        return c.to(torch.int8)[..., None]
    d0 = ((c + 128) & 255) - 128
    d1 = (c - d0) >> 8
    return torch.stack([d0.to(torch.int8), d1.to(torch.int8)], dim=-1)


def _digit_planes(vals, jr: int):
    """Signed values [rows, cols, l] -> digit planes [l*jr, rows, cols],
    row j*jr+dd for coefficient j, digit dd."""
    rows, cols, l = vals.shape
    return _signed_digits(vals, jr).permute(2, 3, 0, 1).reshape(l * jr, rows, cols)


def noise_digit_planes(key, row_offset: int, num_rows: int, cols: int, l: int,
                       bound: int, device="cuda"):
    """Row-keyed bounded-uniform noise (stream v3) as int8 signed digit
    planes [l*jr, num_rows, cols], the layout of the fused noise NTT; None
    when the bound exceeds the signed-digit range. Drawn in row blocks: a
    full-width c2 draw is hundreds of millions of threefry words."""
    from ..sampling.uniform import sample_uniform_signed_rows

    jr = signed_digit_count(bound)
    if not jr:
        return None
    out = torch.empty((l * jr, num_rows, cols), dtype=torch.int8, device=device)
    step = max(1, (1 << 22) // max(1, cols * l))
    for r0 in range(0, num_rows, step):
        r1 = min(num_rows, r0 + step)
        ec = sample_uniform_signed_rows(key, row_offset + r0, r1 - r0,
                                        (cols, l), bound, device)
        out[:, r0:r1] = _digit_planes(ec, jr)
    return out


def ntt_forward_cols_signed(coeffs, ring: "RingPlan", max_abs: int):
    """Forward NTT of small signed coefficients [..., l] (|c| <= max_abs)
    as unfolded columns int32 [L, l, B, nd+jr-1], with the batch shape."""
    jr = signed_digit_count(max_abs)
    if jr == 0:
        raise ValueError(f"coefficients up to {max_abs} need the residue path")
    batch_shape = tuple(coeffs.shape[:-1])
    L, l, nd = ring.num_limbs, ring.degree, ring.num_digits
    C = nd + jr - 1
    b = math.prod(batch_shape)
    xd = _signed_digits(coeffs.reshape(b, l), jr)               # [B, l, jr]
    rhs = xd.permute(1, 2, 0).reshape(1, l * jr, b)
    band = ring.table("ntt_band_jr", coeffs.device, "fwd", jr)
    p = exact_int_matmul(band, rhs)                             # [L, C*l, B]
    return p.reshape(L, C, l, b).permute(0, 2, 3, 1), batch_shape


def ntt_forward_signed(coeffs, ring: "RingPlan", max_abs: int):
    """Signed coefficients [..., l] -> Ntt residues [..., L, l]."""
    cols, batch_shape = ntt_forward_cols_signed(coeffs, ring, max_abs)
    out = _fold_leading(cols, ring)                             # [L, l, B]
    return out.permute(2, 0, 1).reshape(batch_shape + (ring.num_limbs, ring.degree))


def ntt_forward_signed_ch(coeffs, ring: "RingPlan", max_abs: int):
    """:func:`ntt_forward_signed` emitted channel-major: [..., l] ->
    [L, l, ...] (the layout the fused matmul consumes)."""
    cols, batch_shape = ntt_forward_cols_signed(coeffs, ring, max_abs)
    return _fold_leading(cols, ring).reshape((ring.num_limbs, ring.degree) + batch_shape)
