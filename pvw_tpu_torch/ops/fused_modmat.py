"""The fused scaled-digit modular matmul and the fused r-stage: Hopper
kernels and plain twins.

The counterpart of ``pvw_tpu.ops.pallas_modmat.matmul_fold_scaled``. For
each channel (limb, NTT slot) it contracts the lhs digit planes against the
scaled-digit band of the rhs, adds the NTT of the noise digit planes into
the same nd columns, folds the columns to residues and adds the gadget
encode of a u64 scalar tile:

    out[L, S, m, n] = lhs·rhs + NTT(noise) + encode(sc)·g   (mod q)

It carries keygen (b = sᵀA + e1), c1 = A·r + e1 and c2 = B·r + e2 +
encode(m). :func:`matmul_fold_scaled` runs the CUDA kernel
(``csrc/fused_scaled_noise_matmul.cu``) for CUDA tensors and the plain
twin :func:`matmul_fold_scaled_plain` for CPU tensors; it raises for
anything else. The twin repeats the JAX package's XLA route.

:func:`v3k_noise_planes` draws the stream-v3k noise digit planes that the
TPU kernel generates in VMEM (``gen_noise=(seeds, jr, bound, "tfry")``):
on a card it is its own kernel (``csrc/v3k_noise_planes.cu``), launched
once per product ahead of the fused matmul, which reads the planes as its
noise input; its plain twin is :func:`~pvw_tpu_torch.ops.tfry.
v3k_noise_digit_planes`.

:func:`ntt_prescale_band` is the counterpart of
``pvw_tpu.ops.pallas_modmat.ntt_prescale_band``: small signed coefficients
-> signed NTT -> scaled-digit band in one pass, the r-stage of encryption
(``csrc/ntt_prescale_band.cu``; plain twin :func:`ntt_prescale_band_plain`).

Kernel 1's ``masked`` form (6-word v3k seeds: noise and encode only on a
global row range, the kdim-split mesh shards' contract) and its ``post=``
addmod are :func:`matmul_fold_scaled` options; the masked launches are
also counted in ``fused_scaled_noise_matmul.masked_launches``.

Kernels 1 and 3 contract on Hopper's wgmma, fed by TMA
(``csrc/wgmma_digit.cuh``), which reads both int8 operands k-contiguous
with 16-byte strides. Kernel 4 writes the band so, k-packed: storage
[..., nd, n, kd_pad] handed on as the strided view [..., nd, kd, n] (the
same logical band on every device, the same values for every plain-torch
consumer). ``modmat.prescale_digits_band``, the plain-torch band (keygen's, the
twins'), lays it out the same. The entries take such a band as it lies;
a band of any other layout (an n-major copy) gets one explicit relayout
(:func:`_kpacked`), counted in ``band_relayouts``: a layout step, never
another kernel. The lhs rows get the same 16-byte pitch
(:func:`~pvw_tpu_torch.ops.modmat.k_rows`), once where the key planes are
cached; lhs rows without it are copied once, counted in ``row_relayouts``.
The entries (:func:`matmul_fold_scaled`, :func:`matmul_fold_swapped`) are
the one place that lays operands out; the launch wrappers refuse any
operand that does not lie so.

Every launch runs with its operands' device current (CUDA refuses a launch
on another device's stream), so one process drives shards on several
cards.

:func:`matmul_channels_fused` (also :func:`matmul_fold_auto`) is the
counterpart of ``pvw_tpu.ops.pallas_modmat.matmul_channels_pallas``: the
modular matmul of two residue matrices per channel by the digit
convolution, kernel 2 (``csrc/banded_matmul.cu``, on wgmma with a TMA
ring; plain twin :func:`banded_matmul_plain`) on the operands' digit
planes, which :func:`digit_planes_kpacked` lays out k-packed
(``csrc/digit_planes.cu``); the entry's plain twin is
:func:`~pvw_tpu_torch.ops.modmat.matmul_channels`.

Two opt-in forms of the same product, as in the JAX package:

- :func:`matmul_fold_swapped` (``settings.swapped_form``): the Shoup scales
  on the cached lhs planes, the plain digits of r as the rhs; kernel 1's
  swapped variant (``csrc/fused_scaled_noise_matmul.cu``, counted in
  ``fused_scaled_noise_matmul_swapped.launches``; plain twin
  :func:`matmul_fold_swapped_plain`).
- :func:`fused_pipelined_matmul` (``settings.pipeline_fold``): the
  pipelined kernel ``csrc/fused_pipelined_matmul.cu``, which
  :func:`matmul_fold_scaled` takes for CUDA operands, with the v3k noise
  drawn inside it; its plain twin is :func:`matmul_fold_scaled_plain`.
"""

from __future__ import annotations

import ctypes
from typing import TYPE_CHECKING

import numpy as np
import torch

from . import u64 as u
from ._build import load
from .modmat import (_column_sums, _fold_leading, digits, exact_int_matmul, k_rows, k_rows_ok,
                     matmul_channels, operand_strides, prescale_digits_band, scaled_cols)
from .ntt import ntt_forward_signed_ch, signed_digit_count
from .tfry import reduce96, v3k_noise_digit_planes

if TYPE_CHECKING:
    from ..params.ring import RingPlan

KERNEL = "fused_scaled_noise_matmul"
SWAPPED_KERNEL = "fused_scaled_noise_matmul_swapped"     # in KERNEL's source
MASKED_KERNEL = "fused_scaled_noise_matmul_masked"       # KERNEL's masked launches
BANDED_KERNEL = "banded_matmul"
DIGITS_KERNEL = "digit_planes"                           # kernel 2's operand layout
BANDED_TABLE_WIDTH = 10
PIPELINED_KERNEL = "fused_pipelined_matmul"
NOISE_KERNEL = "v3k_noise_planes"
TABLE_WIDTH = 8
PRESCALE_KERNEL = "ntt_prescale_band"
PRESCALE_TABLE_WIDTH = 22
PRESCALE_DEGREES = (8, 16, 32, 64)

#: Bands (and the swapped form's rhs digits) handed to the entries of
#: kernels 1 and 3 in another layout than the k-packed one of kernel 4,
#: ``prescale_digits_band`` and ``rhs_digit_cols``, each relaid once
#: (:func:`_kpacked`); 0 on every dealer path, whose bands all come from
#: those.
band_relayouts = 0
#: lhs rows (``lhs_dig``, the swapped form's ``lhs_planes``) handed to those
#: entries without the 16-byte pitch of :func:`~pvw_tpu_torch.ops.modmat.
#: k_rows`, each copied once (:func:`_laid_rows`); 0 on every dealer path,
#: whose key planes are laid out once, where they are cached.
row_relayouts = 0


# --------------------------------------------------------------------------
# stream-v4 contract helpers (pure functions; the TPU hardware PRNG itself
# exists on no other device)
# --------------------------------------------------------------------------

def v4_blockmix(row0, col0):
    """Per-tile seed perturbation ``(row0/8) << 17 | col0/128``."""
    return ((row0 >> 3) << 17) | (col0 >> 7)


#: Exact 96-bit scaled reduction floor(x96 * rng / 2^96): the v3k and v4
#: streams share it.
v4_reduce96 = reduce96


def v4_digit_split(sv):
    """Signed value -> (d0, d1) signed 8-bit digits, sv == d0 + 256*d1."""
    d0 = ((sv + 128) & 255) - 128
    return d0, (sv - d0) >> 8


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------

def _pack_tables(ring: "RingPlan", ncols: int, width: int = TABLE_WIDTH) -> np.ndarray:
    """Per-limb fold constants, uint64 [L, width]: q, the bias K of
    ``ncols`` columns, then (2^(32g) mod q, its 64-bit Shoup companion) for
    the groups g < (width - 2) / 2 (two for kernel 1, four for kernel 2)."""
    t = np.zeros((ring.num_limbs, width), np.uint64)
    t[:, 0] = ring.q
    t[:, 1] = ring.bias_for_columns(ncols)
    for g in range((width - 2) // 2):
        t[:, 2 + 2 * g], t[:, 3 + 2 * g] = ring.grp_w[:, g], ring.grp_s[:, g]
    return t


def encode_tab(gadget_ntt: np.ndarray, gadget_ntt_shoup: np.ndarray,
               gadget_wrap: np.ndarray) -> np.ndarray:
    """Per-channel gadget-encode constants, uint64 [L*l, 3] rows
    (g, Shoup(g), (2^64 mod q)*g mod q), from the [L, l] tables of
    :class:`PvwParameters`."""
    return np.stack([gadget_ntt.reshape(-1), gadget_ntt_shoup.reshape(-1),
                     gadget_wrap.reshape(-1)], axis=1).astype(np.uint64)


def _noise_vals_mode(ring: "RingPlan", k: int, jr: int, bound) -> bool:
    """True when the value-row noise MAC (jr digit planes composed into one
    int32 value each, against the jr=1 table) is exact: the column bound
    k*nd*2^14 + l*bound*2^7 stays within int32. ``bound`` None assumes the
    largest value jr digits can carry. ``settings.noise_value_mac`` off
    forces the digit-row MAC."""
    from ..config import settings

    if not settings.noise_value_mac:
        return False
    if bound is None:
        bound = 128 * ((256 ** jr) - 1) // 255
    col = k * ring.num_digits * (1 << 14) + ring.degree * int(bound) * (1 << 7)
    return col < (1 << 31)


# --------------------------------------------------------------------------
# the plain twin
# --------------------------------------------------------------------------

def _noise_cols(noise, ring: "RingPlan"):
    """Noise digit planes int8 [l*jr, m, n] -> int32 scaled-digit columns
    [L, S, m, n, nd] of their NTT."""
    R, m, n = noise.shape
    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    tab = ring.table("ntt_scaled_tab", noise.device, R // S)       # [L, S, R, nd]
    p = exact_int_matmul(tab.permute(0, 1, 3, 2).reshape(L * S * nd, R),
                         noise.reshape(R, m * n))
    return p.reshape(L, S, nd, m, n).permute(0, 1, 3, 4, 2)


def _row_keep(row_off: int, rows: int, mask, device):
    """bool [rows]: global row row_off + r (int32, as the TPU kernel's iota)
    lies in the masked form's range ``mask`` = (lo, hi)."""
    g = (int(row_off) + torch.arange(rows, dtype=torch.int64, device=device)) & u.M32
    g = torch.where(g >= 1 << 31, g - (1 << 32), g)
    return (g >= _i32(mask[0])) & (g < _i32(mask[1]))


def _encode_residues(sc, etab, L: int, S: int, ring: "RingPlan"):
    """Gadget encode of u64 scalars sc [m, n] -> residues [L, S, m, n],
    with the ``as i64`` wrap for scalars >= 2^63."""
    tab = etab.reshape(L, S, 3)[:, :, :, None, None]
    q = ring.table("q", sc.device).reshape(L, 1, 1, 1)
    e = u.shoup_mul64_arr(sc, tab[:, :, 0], tab[:, :, 1], q)
    return torch.where(sc < 0, u.submod(e, tab[:, :, 2], q), e)


def matmul_fold_scaled_plain(lhs, rhs_band, ring: "RingPlan", noise=None,
                             encode=None, lhs_dig=None, post=None, mask=None):
    """Plain PyTorch version of :func:`matmul_fold_scaled`: the scaled
    digit columns, plus the noise NTT columns, folded, plus ``post`` and
    the encode; with ``mask`` = (row_off, lo, hi) the encode only on the
    global rows in [lo, hi) (the masked form's noise planes come zeroed
    outside them, :func:`v3k_noise_planes`). It is also the twin of the
    pipelined kernel (:func:`fused_pipelined_matmul`), which computes the
    same function; for its in-kernel v3k noise the planes are
    :func:`~pvw_tpu_torch.ops.tfry.v3k_noise_digit_planes`."""
    return _fold_plain(scaled_cols(lhs, rhs_band, ring, lhs_dig=lhs_dig), ring, noise,
                       encode, post, mask)


def matmul_fold_swapped_plain(lhs_planes, rhs_dig, ring: "RingPlan", noise=None,
                              encode=None):
    """Plain PyTorch version of :func:`matmul_fold_swapped`: column c is
    the digit product of the scaled lhs plane c with the plain rhs digits;
    then the noise NTT columns, the fold and the encode, as in
    :func:`matmul_fold_scaled_plain`."""
    nd = lhs_planes.shape[2]
    cols = torch.stack([exact_int_matmul(lhs_planes[:, :, c], rhs_dig) for c in range(nd)],
                       dim=-1)                                    # [L, S, m, n, nd]
    return _fold_plain(cols, ring, noise, encode)


def _fold_plain(cols, ring: "RingPlan", noise, encode, post=None, mask=None):
    """int32 columns [L, S, m, n, nd] (+ the noise NTT columns) -> folded
    residues [L, S, m, n] (+ ``post``, + the encode, on the rows ``mask``
    keeps)."""
    if noise is not None:
        cols = cols + _noise_cols(noise, ring)
    out = _fold_leading(cols, ring)
    L, S, m = out.shape[:3]
    q = ring.table("q", out.device).reshape(L, 1, 1, 1)
    if post is not None:
        out = u.addmod(out, post, q)
    if encode is not None:
        enc = _encode_residues(encode[0], encode[1], L, S, ring)
        if mask is not None:
            enc = enc * _row_keep(mask[0], m, mask[1:], out.device)[:, None]
        out = u.addmod(out, enc, q)
    return out


# --------------------------------------------------------------------------
# the band's layout
# --------------------------------------------------------------------------

def _kpacked(band):
    """A band int8 [..., nd, kd, n] laid out k-packed (storage [..., nd, n,
    kd_pad], kd_pad = kd rounded up to 16, the pads zero, as the view
    [..., nd, kd, n]): ``band`` itself when it lies so, else one relayout
    (:func:`~pvw_tpu_torch.ops.modmat.k_rows` of its transpose), counted in
    ``band_relayouts``."""
    global band_relayouts
    rows = band.transpose(-1, -2)
    if k_rows_ok(rows):
        return band
    band_relayouts += 1
    return k_rows(rows).transpose(-1, -2)


def _laid_rows(rows):
    """int8 lhs rows [..., kd] as the kernels read them: ``rows`` itself
    when :func:`~pvw_tpu_torch.ops.modmat.k_rows_ok`, else one copy
    (:func:`~pvw_tpu_torch.ops.modmat.k_rows`), counted in
    ``row_relayouts``."""
    global row_relayouts
    if k_rows_ok(rows):
        return rows
    row_relayouts += 1
    return k_rows(rows)


# --------------------------------------------------------------------------
# the CUDA kernels: kernel 1 (banded and swapped) and the pipelined kernel
# --------------------------------------------------------------------------

# the C signatures of kernel 1's two entry points and the pipelined kernel's:
# each begins with its two int8 operands, A [CH, rows, kd] (pointer, row and
# channel strides) and B [CH, nd, cols, kd] (pointer, row, plane and channel
# strides)
_OPERANDS = [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] \
    + [ctypes.c_longlong] * 3
KERNEL1_ARGTYPES = _OPERANDS + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
PIPELINED_ARGTYPES = _OPERANDS + [ctypes.c_void_p] * 3 + [ctypes.c_uint32] * 4 \
    + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p]


def _kernel_fn(symbol: str = "pvw_fused_scaled_noise_matmul"):
    fn = getattr(load(KERNEL), symbol)
    fn.argtypes = KERNEL1_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _ptr(t):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _launch(name: str, fn, dev, *args) -> None:
    """Call a kernel's C entry ``fn(*args, stream)`` with ``dev`` current and
    its current stream; raise on a CUDA error."""
    with torch.cuda.device(dev):
        err = fn(*args, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err}")


def _i32(w: int) -> int:
    """The int32 that a 32-bit word's bits spell."""
    w = int(w) & u.M32
    return w - (1 << 32) if w >= 1 << 31 else w


def _check_args(dev, args: dict) -> None:
    """Raise unless every (tensor, dtype, shape) of ``args`` is contiguous
    on ``dev`` with that dtype and shape; None entries are skipped."""
    for name, (t, dtype, shape) in args.items():
        if t is None:
            continue
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _operands(a, b) -> list:
    """The ctypes arguments of A [CH, rows, kd] and B [CH, nd, cols, kd]
    (checked by :func:`_check_operands`): pointer, then the row, (plane,)
    channel strides in bytes."""
    a_ch, a_row = operand_strides(a)
    b_ch, b_plane, b_row = operand_strides(b)
    return [_ptr(a), a_row, a_ch, _ptr(b), b_row, b_plane, b_ch]


def _check_operands(dev, args: dict) -> None:
    """Raise unless every (rows, shape) of ``args`` is int8 of that shape on
    ``dev``, k last, laid out as :func:`~pvw_tpu_torch.ops.modmat.k_rows_ok`
    requires (the entries lay operands out; a launch never copies one)."""
    for name, (t, shape) in args.items():
        if t.device != dev or t.dtype != torch.int8 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected int8 {shape} on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if not k_rows_ok(t):
            raise ValueError(f"{name}: the rows must lie k-contiguous with 16-byte strides "
                             f"(modmat.k_rows_ok), got strides {tuple(t.stride())}")


def _epilogue_args(ch: int, m: int, n: int, nd: int, tables, ntab, noise, sc, etab,
                   post=None) -> dict:
    return {"tables": (tables, torch.int64, (ch, TABLE_WIDTH)),
            "ntab": (ntab, torch.int32, (ch, ntab.shape[1], nd)),
            "noise": (noise, torch.int8, None if noise is None else (noise.shape[0], m, n)),
            "sc": (sc, torch.int64, (m, n)),
            "etab": (etab, torch.int64, None if sc is None else (ch, 3)),
            "post": (post, torch.int64, (ch, m, n))}


def _launch_kernel1(symbol: str, a, b, ch: int, m: int, n: int, kd: int, nd: int, tables,
                    ntab, noise, sc, etab, jr: int, vals: bool, encode32: bool, post=None,
                    mask=None):
    """Kernel 1's launch on A [CH, rows, kd] and B [CH, nd, cols, kd], both
    checked by :func:`_check_operands` -> int64 [CH, m, n]."""
    dev = a.device
    _check_args(dev, _epilogue_args(ch, m, n, nd, tables, ntab, noise, sc, etab, post))
    nrows = ntab.shape[1] if noise is not None else 0
    row_off, lo, hi = (0, 0, 0) if mask is None else (_i32(w) for w in mask)
    out = torch.empty((ch, m, n), dtype=torch.int64, device=dev)
    _launch(symbol, _kernel_fn(symbol), dev, *_operands(a, b),
            _ptr(tables), _ptr(ntab), _ptr(noise), _ptr(sc), _ptr(etab), _ptr(post),
            _ptr(out), ch, m, n, kd, nd, nrows, int(jr), int(vals), int(encode32),
            int(mask is not None), row_off, lo, hi)
    return out


def _banded_operands(lhs_dig, band) -> tuple:
    """(lhs rows [CH, m, kd], the band's planes [CH, nd, n, kd], (ch, m, n,
    kd, nd)), both checked by :func:`_check_operands`."""
    ch, m, kd = lhs_dig.shape
    nd, n = band.shape[1], band.shape[3]
    planes = band.transpose(-1, -2)
    _check_operands(lhs_dig.device, {"lhs_dig": (lhs_dig, (ch, m, kd)),
                                     "band": (planes, (ch, nd, n, kd))})
    return lhs_dig, planes, (ch, m, n, kd, nd)


def fused_scaled_noise_matmul(lhs_dig, band, tables, ntab, noise, sc, etab,
                              jr: int, vals: bool, encode32: bool, post=None, mask=None):
    """Launch the kernel on the current stream. lhs_dig int8 [CH, m, kd]
    with 16-byte rows; band int8 [CH, nd, kd, n], k-packed as
    :func:`ntt_prescale_band` makes it (other layouts raise: the entry
    lays operands out); tables int64 [CH, 8]; ntab int32
    [CH, rows, nd]; noise int8 [l*jr, m, n] or None; sc int64 [m, n] and
    etab int64 [CH, 3], or both None; post int64 [CH, m, n] canonical
    residues or None; ``mask`` = (row_off, lo, hi) or None -> int64
    [CH, m, n]. The masked form adds the encode only on the global rows
    row_off + r in [lo, hi) (its noise planes come zeroed outside them);
    ``post`` lands on every row. Counts its launches in
    ``fused_scaled_noise_matmul.launches``, the masked ones also in
    ``.masked_launches`` and those with neither noise, encode nor post in
    ``.bare_launches``."""
    a, b, dims = _banded_operands(lhs_dig, band)
    out = _launch_kernel1("pvw_fused_scaled_noise_matmul", a, b, *dims,
                          tables, ntab, noise, sc, etab, jr, vals, encode32, post, mask)
    fused_scaled_noise_matmul.launches += 1
    if mask is not None:
        fused_scaled_noise_matmul.masked_launches += 1
    if noise is None and sc is None and post is None:
        fused_scaled_noise_matmul.bare_launches += 1
    return out


fused_scaled_noise_matmul.launches = 0
fused_scaled_noise_matmul.masked_launches = 0
fused_scaled_noise_matmul.bare_launches = 0


def fused_scaled_noise_matmul_swapped(lhs_planes, rhs_t, tables, ntab, noise, sc, etab,
                                      jr: int, vals: bool, encode32: bool):
    """Launch kernel 1's swapped form on the current stream. lhs_planes int8
    [CH, nd, m, kd] (scaled planes); rhs_t int8 [CH, n, kd] (the plain rhs
    digits, k-packed); both laid out as :func:`~pvw_tpu_torch.ops.modmat.
    k_rows_ok` requires (else it raises); the rest as
    :func:`fused_scaled_noise_matmul` -> int64
    [CH, m, n]. Counts its launches in
    ``fused_scaled_noise_matmul_swapped.launches``."""
    ch, nd, m, kd = lhs_planes.shape
    n = rhs_t.shape[1]
    _check_operands(lhs_planes.device, {"lhs_planes": (lhs_planes, (ch, nd, m, kd)),
                                        "rhs_t": (rhs_t, (ch, n, kd))})
    out = _launch_kernel1("pvw_fused_scaled_noise_matmul_swapped", rhs_t, lhs_planes,
                          ch, m, n, kd, nd, tables, ntab, noise, sc, etab, jr, vals,
                          encode32)
    fused_scaled_noise_matmul_swapped.launches += 1
    return out


fused_scaled_noise_matmul_swapped.launches = 0


def _pipelined_fn():
    fn = load(PIPELINED_KERNEL).pvw_fused_pipelined_matmul
    fn.argtypes = PIPELINED_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def fused_pipelined_matmul(lhs_dig, band, tables, ntab, noise, gen, sc, etab, l: int,
                           jr: int, vals: bool, encode32: bool):
    """Launch the pipelined kernel on the current stream: the function of
    :func:`fused_scaled_noise_matmul`, one block walking every channel of
    its output tile. The noise is ``noise`` int8 [l*jr, m, n], or ``gen`` =
    (k0, k1, row_off, col_off, bound), the v3k values drawn inside the
    kernel, or neither (ntab then unused). The band as for
    :func:`fused_scaled_noise_matmul`. Counts its launches in
    ``fused_pipelined_matmul.launches``."""
    a, b, (ch, m, n, kd, nd) = _banded_operands(lhs_dig, band)
    dev = lhs_dig.device
    _check_args(dev, _epilogue_args(ch, m, n, nd, tables, ntab, noise, sc, etab))
    if gen is not None and noise is not None:
        raise ValueError("gen and noise are mutually exclusive")
    k0, k1, row_off, col_off, bound = (int(w) for w in gen) if gen is not None else (0,) * 5
    nrows = ntab.shape[1] if noise is not None or gen is not None else 0
    out = torch.empty((ch, m, n), dtype=torch.int64, device=dev)
    _launch(PIPELINED_KERNEL, _pipelined_fn(), dev, *_operands(a, b),
            _ptr(tables), _ptr(ntab), _ptr(noise),
            k0 & u.M32, k1 & u.M32, row_off & u.M32, col_off & u.M32, bound, _ptr(sc),
            _ptr(etab), _ptr(out), ch, m, n, kd, nd, l, int(jr), nrows, int(vals),
            int(encode32), int(gen is not None))
    fused_pipelined_matmul.launches += 1
    return out


fused_pipelined_matmul.launches = 0


# --------------------------------------------------------------------------
# stream-v3k noise generation
# --------------------------------------------------------------------------

def _noise_fn():
    fn = load(NOISE_KERNEL).pvw_v3k_noise_planes
    fn.argtypes = [ctypes.c_uint32] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    return fn


def v3k_noise_planes_plain(k0, k1, row_off: int, rows: int, cols: int, l: int,
                           bound: int, col_off: int = 0, device="cpu", mask=None):
    """Plain PyTorch version of :func:`v3k_noise_planes`: the v3k planes,
    zeroed on the global rows outside ``mask`` = (lo, hi)."""
    planes = v3k_noise_digit_planes(k0, k1, row_off, rows, cols, l, bound, col_off, device)
    if mask is not None:
        planes *= _row_keep(row_off, rows, mask, planes.device)[:, None]
    return planes


def v3k_noise_planes(k0, k1, row_off: int, rows: int, cols: int, l: int, bound: int,
                     col_off: int = 0, device="cuda", mask=None):
    """Stream-v3k noise as int8 signed digit planes [l*jr, rows, cols] for
    global rows from ``row_off`` and columns from ``col_off``, equal to
    :func:`~pvw_tpu_torch.ops.tfry.v3k_noise_digit_planes`; with ``mask`` =
    (lo, hi) the global rows outside [lo, hi) are zero (the masked form). A
    CUDA device launches ``csrc/v3k_noise_planes.cu`` on the current stream
    (counted in ``v3k_noise_planes.launches``); the CPU takes the plain twin
    :func:`v3k_noise_planes_plain`; anything else raises. The bound must
    have signed digits (<= 32639)."""
    jr = signed_digit_count(bound)
    if not jr:
        raise ValueError(f"noise bound {bound} has no signed digits (> 32639)")
    dev = torch.device(device)
    if dev.type == "cpu":
        return v3k_noise_planes_plain(k0, k1, row_off, rows, cols, l, bound, col_off, dev,
                                      mask)
    if dev.type != "cuda":
        raise ValueError(f"v3k_noise_planes: unsupported device {dev}")
    lo, hi = (0, 0) if mask is None else (_i32(w) for w in mask)
    out = torch.empty((l * jr, rows, cols), dtype=torch.int8, device=dev)
    _launch(NOISE_KERNEL, _noise_fn(), dev, int(k0) & u.M32, int(k1) & u.M32,
            int(row_off) & u.M32, int(col_off) & u.M32, rows, cols, l, jr, int(bound),
            int(mask is not None), lo, hi, _ptr(out))
    v3k_noise_planes.launches += 1
    return out


v3k_noise_planes.launches = 0


def kernel_noise_available(bound: int, tfry: bool = False, device="cuda") -> bool:
    """True when :func:`matmul_fold_scaled` takes ``gen_noise``: the v3k
    stream (``tfry``) with a bound that has signed digits, on a CUDA card
    (the generator kernel) or the CPU (its plain twin); the card takes any
    size, so the JAX package's shape arguments are not needed. Stream v4
    is the TPU hardware PRNG, which no other device has: False on every
    device."""
    if not tfry or not signed_digit_count(bound):
        return False
    return torch.device(device).type in ("cpu", "cuda")


def _gen_words(gen_noise):
    """((key0, key1, row_offset, col_offset), jr, bound, mask) of
    ``gen_noise`` = (seeds, jr, bound, "tfry"), the seeds as int32 words
    (the JAX layout): 4 words (key0, key1, row_offset, col_offset), mask
    None; or the masked form's 6, (key0, key1, row_offset, lo, hi,
    col_offset), mask (lo, hi): the column offset is then word 5. Stream v4
    (no "tfry") raises."""
    if len(gen_noise) < 4 or gen_noise[3] != "tfry":
        raise NotImplementedError(
            "gen_noise without 'tfry' is stream v4, the TPU hardware PRNG "
            "(pltpu.prng_*), which no other device has; use stream v3k or "
            "noise digit planes")
    seeds, jr, bound = gen_noise[0], int(gen_noise[1]), int(gen_noise[2])
    words = [int(w) & u.M32 for w in (seeds.tolist() if torch.is_tensor(seeds) else seeds)]
    if len(words) == 4:
        mask = None
    elif len(words) == 6:
        mask = (words[3], words[4])
        words = [*words[:3], words[5]]
    else:
        raise ValueError(f"gen_noise seeds of {len(words)} words: pass (key0, key1, "
                         "row_offset, col_offset) or, masked, (key0, key1, row_offset, "
                         "lo, hi, col_offset)")
    if jr != signed_digit_count(bound):
        raise ValueError(f"gen_noise jr {jr} does not match bound {bound}")
    return tuple(words), jr, bound, mask


def gen_noise_planes(gen_noise, m: int, n: int, l: int, device):
    """The planes [l*jr, m, n] that ``gen_noise`` = (seeds, jr, bound,
    "tfry") stands for, from :func:`v3k_noise_planes` (zeroed outside the
    masked form's rows)."""
    (k0, k1, row_off, col_off), _, bound, mask = _gen_words(gen_noise)
    return v3k_noise_planes(k0, k1, row_off, m, n, l, bound, col_off, device, mask)


def pipeline_takes(device, bare: bool = False, masked: bool = False,
                   post: bool = False) -> bool:
    """True when :func:`matmul_fold_scaled` launches the pipelined kernel:
    ``settings.pipeline_fold`` on, a CUDA device, and a product with noise
    or an encode (the JAX package sends the bare product to its banded
    kernel, ``pallas_modmat.py:1387-1390``), neither masked nor with
    ``post`` (the JAX package sends those to kernel 1, ``:1420-1422``).
    Then ``gen_noise`` is drawn inside that kernel, with no generator launch
    ahead of it."""
    from ..config import settings

    return (bool(settings.pipeline_fold) and not (bare or masked or post)
            and torch.device(device).type == "cuda")


# --------------------------------------------------------------------------
# the public wrappers
# --------------------------------------------------------------------------

def _noise_jr(planes: int, ring: "RingPlan", S: int) -> int:
    """Digit planes per coefficient of ``planes`` noise digit planes (0
    without noise)."""
    if not planes:
        return 0
    if S != ring.degree:
        raise ValueError("noise fusion requires the channel minor axis "
                         "to be the NTT point axis (S == ring.degree)")
    jr = planes // ring.degree
    if planes != S * jr or jr not in (1, 2):
        raise ValueError("noise digit planes must have l*jr rows, jr in (1, 2)")
    return jr


def _same_device(name: str, dev, *tensors) -> None:
    if any(t is not None and t.device != dev for t in tensors):
        raise ValueError(f"{name}: operands on different devices")


def _kernel_tables(ring: "RingPlan", L: int, S: int, k: int, jr: int, noise_bound,
                   encode, dev):
    """(vals, tables, ntab, sc, etab) of a launch: the value-row decision
    (:func:`_noise_vals_mode`, jr 0 without noise), the fold tables per
    channel, the noise table (a zero row without noise) and the encode."""
    nd = ring.num_digits
    vals = bool(jr) and _noise_vals_mode(ring, k, jr, noise_bound)
    if jr:
        ntab = ring.table("ntt_scaled_tab", dev, 1 if vals else jr)
        ntab = ntab.to(torch.int32).reshape(L * S, ntab.shape[2], nd).contiguous()
    else:
        ntab = torch.zeros((L * S, 1, nd), dtype=torch.int32, device=dev)
    tables = u.u64_tensor(_pack_tables(ring, nd), dev).repeat_interleave(S, dim=0)
    sc = etab = None
    if encode is not None:
        sc, etab = encode[0].contiguous(), encode[1].contiguous()
    return vals, tables, ntab, sc, etab


def matmul_fold_scaled(lhs, rhs_band, ring: "RingPlan", noise=None,
                       encode=None, lhs_dig=None, encode32: bool = False,
                       gen_noise=None, noise_bound=None, post=None):
    """Fused modular matmul against a scaled-digit band.

    lhs: residues [L, S, m, k], or ``lhs_dig`` int8 [L, S, m, k*nd] (its
    digit planes, :func:`~pvw_tpu_torch.ops.modmat.lhs_digit_planes`);
    rhs_band: int8 [L, S, nd, k*nd, n] from :func:`ntt_prescale_band` or
    :func:`~pvw_tpu_torch.ops.modmat.prescale_digits_band`, k-packed; a
    band of another layout is relaid once (:func:`_kpacked`), an
    ``lhs_dig`` without 16-byte rows copied once (:func:`_laid_rows`), on
    every device -> int64 residues [L, S, m, n].

    ``noise``: int8 signed digit planes [l*jr, m, n] (row j*jr+dd for
    coefficient j, digit dd); requires S == l. Adds NTT(noise).
    ``noise_bound``: the true bound of the values behind ``noise``; lets
    the kernel compose the planes into values (:func:`_noise_vals_mode`).
    ``encode``: (sc int64 [m, n] u64 patterns, etab int64 [L*S, 3] from
    :func:`encode_tab`); adds encode(sc)·g with the ``as i64`` wrap.
    ``encode32``: every scalar is < 2^32 (the caller checked).
    ``gen_noise``: (seeds, jr, bound, "tfry") adds the stream-v3k noise
    [l*jr, m, n] (seeds (key0, key1, row_offset, col_offset) as int32
    words) with ``noise_bound`` = bound: drawn by :func:`v3k_noise_planes`
    ahead of kernel 1, or inside the pipelined kernel. Six words (key0,
    key1, row_offset, lo, hi, col_offset) select the masked form: the noise
    and the encode land only on the global rows row_offset + r in [lo, hi)
    (kernel 1's masked launch, never the pipelined kernel). Stream v4 (a
    3-tuple) raises ``NotImplementedError``.
    ``post``: canonical residues [L, S, m, n] added after the fold.

    CUDA operands launch kernel 1 (``csrc/fused_scaled_noise_matmul.cu``),
    or the pipelined kernel (``csrc/fused_pipelined_matmul.cu``) where
    :func:`pipeline_takes`; CPU operands take the plain twin; any other
    device raises.
    """
    if gen_noise is not None and noise is not None:
        raise ValueError("gen_noise and noise are mutually exclusive")
    nd = ring.num_digits
    if lhs_dig is None:
        L, S, m, k = lhs.shape
        dev = lhs.device
    else:
        L, S, m, kd = lhs_dig.shape
        k = kd // nd
        dev = lhs_dig.device
    if k > u.MAX_CONTRACTION:
        raise ValueError(f"contraction {k} exceeds int32 headroom {u.MAX_CONTRACTION}")
    if tuple(rhs_band.shape[:4]) != (L, S, nd, k * nd):
        raise ValueError(f"rhs_band shape {tuple(rhs_band.shape)} does not match "
                         f"[L={L}, S={S}, nd={nd}, kd={k * nd}, n]")
    n = rhs_band.shape[4]
    gwords = gmask = gen = None
    if gen_noise is not None:
        gwords, gjr, gbound, gmask = _gen_words(gen_noise)
    pipelined = pipeline_takes(
        dev, bare=noise is None and gen_noise is None and encode is None,
        masked=gmask is not None, post=post is not None)
    mask = None if gmask is None else (gwords[2], *gmask)      # (row_off, lo, hi)
    if gen_noise is not None and pipelined:
        gen, noise_bound = (*gwords, gbound), gbound
    elif gen_noise is not None:
        noise = gen_noise_planes(gen_noise, m, n, ring.degree, dev)
        noise_bound = gbound
    jr = _noise_jr(ring.degree * gjr if gen else 0 if noise is None else noise.shape[0],
                   ring, S)
    _same_device("matmul_fold_scaled", dev, lhs, lhs_dig, rhs_band, noise, post,
                 *(encode if encode is not None else ()))
    rhs_band = _kpacked(rhs_band)
    if lhs_dig is not None:
        lhs_dig = _laid_rows(lhs_dig)
    if dev.type == "cpu":
        return matmul_fold_scaled_plain(lhs, rhs_band, ring, noise=noise,
                                        encode=encode, lhs_dig=lhs_dig, post=post, mask=mask)
    if dev.type != "cuda":
        raise ValueError(f"matmul_fold_scaled: unsupported device {dev}")
    ld = lhs_dig if lhs_dig is not None else k_rows(digits(lhs, nd).reshape(L, S, m, k * nd))
    vals, tables, ntab, sc, etab = _kernel_tables(ring, L, S, k, jr, noise_bound, encode,
                                                  dev)
    ld = ld.reshape(L * S, m, k * nd)
    band = rhs_band.reshape(L * S, nd, k * nd, n)        # a view: still k-packed
    noise = None if noise is None else noise.contiguous()
    if pipelined:
        out = fused_pipelined_matmul(ld, band, tables, ntab, noise, gen, sc, etab,
                                     ring.degree, jr, vals, encode32)
    else:
        out = fused_scaled_noise_matmul(
            ld, band, tables, ntab, noise, sc, etab, jr, vals, encode32,
            None if post is None else post.reshape(L * S, m, n).contiguous(), mask)
    return out.reshape(L, S, m, n)


def matmul_fold_swapped(lhs_planes, rhs_dig, ring: "RingPlan", noise=None, encode=None,
                        encode32: bool = False, gen_noise=None, noise_bound=None):
    """Fused modular matmul with the Shoup scales on the cached lhs.

    lhs_planes: int8 [L, S, nd(c), m, k*nd(i)] from
    :func:`~pvw_tpu_torch.ops.modmat.lhs_scaled_planes`; rhs_dig: int8
    [L, S, k*nd(i), n] from :func:`~pvw_tpu_torch.ops.modmat.rhs_digit_cols`
    (the plain digits of r) -> int64 residues [L, S, m, n]. Column c is
    sum_{k,i} digit_c(A*2^(8i) mod q) * digit_i(r): the columns, fold and
    residues of :func:`matmul_fold_scaled`. ``noise``, ``encode``,
    ``encode32``, ``gen_noise`` (the generator's planes) and
    ``noise_bound``: as there.

    ``rhs_dig`` is taken as it lies where it is k-packed, as
    ``rhs_digit_cols`` makes it (storage [L, S, n, kd_pad]), else relaid
    once (:func:`_kpacked`); ``lhs_planes`` without 16-byte rows are copied
    once (:func:`_laid_rows`); on every device. CUDA operands launch kernel
    1's swapped form; CPU operands take the plain twin
    :func:`matmul_fold_swapped_plain`; any other device raises. The JAX
    package's Mosaic tile model and compile caps (``_pick_tiles_swapped``,
    ``swapped_available``) have no counterpart: the kernel takes any shape.
    """
    if gen_noise is not None and noise is not None:
        raise ValueError("gen_noise and noise are mutually exclusive")
    nd = ring.num_digits
    L, S, C, m, kd = lhs_planes.shape
    k = kd // nd
    if C != nd or kd != k * nd:
        raise ValueError(f"lhs_planes shape {tuple(lhs_planes.shape)} does not match "
                         f"[L, S, nd={nd}, m, k*nd]")
    if k > u.MAX_CONTRACTION:
        raise ValueError(f"contraction {k} exceeds int32 headroom {u.MAX_CONTRACTION}")
    if tuple(rhs_dig.shape[:3]) != (L, S, kd):
        raise ValueError(f"rhs_dig shape {tuple(rhs_dig.shape)} does not match "
                         f"[L={L}, S={S}, kd={kd}, n]")
    n = rhs_dig.shape[3]
    dev = lhs_planes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"matmul_fold_swapped: unsupported device {dev}")
    if gen_noise is not None:
        if _gen_words(gen_noise)[3] is not None:
            raise ValueError("matmul_fold_swapped has no masked form (6-word seeds)")
        noise = gen_noise_planes(gen_noise, m, n, ring.degree, dev)
        noise_bound = int(gen_noise[2])
    jr = _noise_jr(0 if noise is None else noise.shape[0], ring, S)
    _same_device("matmul_fold_swapped", dev, rhs_dig, noise,
                 *(encode if encode is not None else ()))
    rhs_dig, lhs_planes = _kpacked(rhs_dig), _laid_rows(lhs_planes)
    if dev.type == "cpu":
        return matmul_fold_swapped_plain(lhs_planes, rhs_dig, ring, noise=noise,
                                         encode=encode)
    vals, tables, ntab, sc, etab = _kernel_tables(ring, L, S, k, jr, noise_bound, encode,
                                                  dev)
    out = fused_scaled_noise_matmul_swapped(
        lhs_planes.reshape(L * S, nd, m, kd), rhs_dig.reshape(L * S, kd, n).transpose(1, 2),
        tables, ntab,
        None if noise is None else noise.contiguous(), sc, etab, jr, vals, encode32)
    return out.reshape(L, S, m, n)


# --------------------------------------------------------------------------
# kernel 2: the product of two residue matrices by the digit convolution
# --------------------------------------------------------------------------

_BANDED_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] \
    + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]

#: The balanced-digit bias: byte j of ``(x + DIGIT_BIAS) ^ DIGIT_BIAS`` is
#: digit j of x's balanced base-256 form (the final carry dropped), as
#: kernel 4 splits its scales (``csrc/ntt_prescale_band.cu``, step (d)).
DIGIT_BIAS = 0x8080808080808080 - (1 << 64)                  # as int64

#: Fold and prescale tables built for a launch (:func:`_banded_tables`,
#: :func:`_prescale_tables`); each is built once per ring and device.
table_builds = 0


def digit_planes_kpacked_plain(x, nd: int, transpose: bool = False):
    """Plain PyTorch version of :func:`digit_planes_kpacked`: one int64
    add and one xor give all eight digits (:data:`DIGIT_BIAS`), and one
    strided copy of their first nd bytes lays the planes out."""
    if transpose:
        x = x.transpose(-1, -2)
    ch, rows, k = x.shape
    y = torch.empty((ch, rows, k), dtype=torch.int64, device=x.device)
    torch.add(x, DIGIT_BIAS, out=y)
    y ^= DIGIT_BIAS
    store = torch.empty((ch, nd, rows, -(-k // 16) * 16), dtype=torch.int8, device=x.device)
    store[..., k:] = 0
    planes = store[..., :k]
    planes.copy_(y.view(torch.int8).reshape(ch, rows, k, 8)[..., :nd].permute(0, 3, 1, 2))
    return planes


def _digits_fn():
    fn = load(DIGITS_KERNEL).pvw_digit_planes
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def digit_planes_kpacked(x, nd: int, transpose: bool = False):
    """Residues x int64 [CH, rows, k] (``transpose``: [CH, k, rows]) ->
    their nd balanced signed digits as int8 planes [CH, nd, rows, k], laid
    out k-packed as kernel 2 reads them: storage [CH, nd, rows, k_pad]
    (k_pad = k rounded up to 16, the pads zero) returned as the view
    [..., :k]. The digits are those of ``u64.to_signed_digits``.

    CUDA tensors launch ``csrc/digit_planes.cu`` on the current stream
    (counted in ``digit_planes_kpacked.launches``); CPU tensors take the
    plain twin :func:`digit_planes_kpacked_plain`; anything else raises."""
    dev = x.device
    if dev.type == "cpu":
        return digit_planes_kpacked_plain(x, nd, transpose)
    if dev.type != "cuda":
        raise ValueError(f"digit_planes_kpacked: unsupported device {dev}")
    if x.dtype != torch.int64:
        raise ValueError(f"digit_planes_kpacked: expected int64 residues, got {x.dtype}")
    if transpose:
        x = x.transpose(-1, -2)
    ch, rows, k = x.shape
    store = torch.empty((ch, nd, rows, -(-k // 16) * 16), dtype=torch.int8, device=dev)
    _launch(DIGITS_KERNEL, _digits_fn(), dev, _ptr(x), *x.stride(), _ptr(store), ch, rows, k,
            store.shape[-1], nd)
    digit_planes_kpacked.launches += 1
    return store[..., :k]


digit_planes_kpacked.launches = 0


def _banded_tables(ring: "RingPlan", S: int, device):
    """Kernel 2's fold tables int64 [L*S, 10] (:func:`_pack_tables` of
    2nd-1 columns, four groups, each limb's row repeated for its S
    channels), cached per (ring, S, device)."""
    def make(dev):
        global table_builds
        table_builds += 1
        nd = ring.num_digits
        return u.u64_tensor(_pack_tables(ring, 2 * nd - 1, BANDED_TABLE_WIDTH),
                            dev).repeat_interleave(S, dim=0)

    return ring.cached(("banded_tables", S), device, make)


def banded_matmul_plain(lhs_planes, rhs_planes, tables):
    """Plain PyTorch version of :func:`banded_matmul`, the kernel's
    contract: the nd^2 digit-pair products a_i . b_j summed into the
    2nd-1 columns c = i + j, then the grouped fold with the tables' q, bias
    and four (2^(32g) mod q, Shoup companion) pairs -> int64 [CH, m, n]."""
    ch, nd, m, k = lhs_planes.shape
    n = rhs_planes.shape[2]
    p = exact_int_matmul(lhs_planes.reshape(ch, nd * m, k),
                         rhs_planes.reshape(ch, nd * n, k).transpose(1, 2))
    cols = _column_sums(p.reshape(ch, nd, m, nd, n), nd)           # [CH, m, n, C]
    t = tables[:, None, None]
    return u.fold_columns_grouped(cols, t[..., 2:10:2], t[..., 3:10:2], t[..., 1], t[..., 0])


def _banded_fn():
    fn = load(BANDED_KERNEL).pvw_banded_matmul
    fn.argtypes = _BANDED_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def banded_matmul(lhs_planes, rhs_planes, tables):
    """Launch kernel 2 on the current stream. lhs_planes int8 [CH, nd, m, k]
    and rhs_planes int8 [CH, nd, n, k]: the balanced digits of the two
    residue matrices, digit-major, k contiguous, laid out as
    :func:`~pvw_tpu_torch.ops.modmat.k_rows_ok` requires (16-byte strides:
    :func:`digit_planes_kpacked` makes them so; other layouts raise);
    tables int64 [CH, 10] (:func:`_banded_tables`) -> int64 [CH, m, n].
    Counts its launches in ``banded_matmul.launches``. CPU tensors take
    the plain twin :func:`banded_matmul_plain`."""
    ch, nd, m, k = lhs_planes.shape
    n = rhs_planes.shape[2]
    dev = lhs_planes.device
    if dev.type == "cpu":
        return banded_matmul_plain(lhs_planes, rhs_planes, tables)
    _check_operands(dev, {"lhs_planes": (lhs_planes, (ch, nd, m, k)),
                          "rhs_planes": (rhs_planes, (ch, nd, n, k))})
    _check_args(dev, {"tables": (tables, torch.int64, (ch, BANDED_TABLE_WIDTH))})
    a_ch, a_plane, a_row = operand_strides(lhs_planes)
    b_ch, b_plane, b_row = operand_strides(rhs_planes)
    out = torch.empty((ch, m, n), dtype=torch.int64, device=dev)
    _launch(BANDED_KERNEL, _banded_fn(), dev, _ptr(lhs_planes), a_row, a_plane, a_ch,
            _ptr(rhs_planes), b_row, b_plane, b_ch, _ptr(tables), _ptr(out), ch, m, n, k, nd)
    banded_matmul.launches += 1
    return out


banded_matmul.launches = 0


def matmul_channels_fused(lhs, rhs, ring: "RingPlan"):
    """Modular matmul per (limb, slot) channel, the counterpart of the JAX
    package's fused ``matmul_channels_pallas``: residues lhs [L, S, m, k]
    and rhs [L, S, k, n] -> [L, S, m, n].

    CUDA operands launch kernel 2 (``csrc/banded_matmul.cu``) on their
    balanced digits, laid out by ``csrc/digit_planes.cu``
    (:func:`digit_planes_kpacked`), with the fold tables cached per ring
    (:func:`_banded_tables`); CPU operands take the plain twin
    :func:`~pvw_tpu_torch.ops.modmat.matmul_channels`; any other device
    raises. The JAX package's tile arguments have no counterpart, nor has
    its band in device memory (``_build_band_cmajor``): the kernel reads
    windows of the rhs digit planes between zero blocks in shared
    memory."""
    L, S, m, k = lhs.shape
    n = rhs.shape[-1]
    if tuple(rhs.shape[:3]) != (L, S, k):
        raise ValueError(f"rhs shape {tuple(rhs.shape)} does not match [L={L}, S={S}, "
                         f"k={k}, n]")
    if k > u.MAX_CONTRACTION:
        raise ValueError(f"contraction {k} exceeds int32 headroom {u.MAX_CONTRACTION}")
    dev = lhs.device
    _same_device("matmul_channels_fused", dev, rhs)
    if dev.type == "cpu":
        return matmul_channels(lhs, rhs, ring)
    if dev.type != "cuda":
        raise ValueError(f"matmul_channels_fused: unsupported device {dev}")
    nd = ring.num_digits
    a = digit_planes_kpacked(lhs.reshape(L * S, m, k), nd)
    b = digit_planes_kpacked(rhs.reshape(L * S, k, n), nd, transpose=True)
    return banded_matmul(a, b, _banded_tables(ring, S, dev)).reshape(L, S, m, n)


#: The JAX package's ``matmul_fold_auto`` (Pallas on a TPU, XLA elsewhere):
#: kernel 2 on a card, the plain twin on the CPU.
matmul_fold_auto = matmul_channels_fused


# --------------------------------------------------------------------------
# the fused r-stage: signed NTT + scaled-digit band
# --------------------------------------------------------------------------

def _prescale_tabs(ring: "RingPlan", C1: int) -> np.ndarray:
    """Per-limb constants of the prescale kernel, uint64 [L, 22]: q, the
    bias K of ``C1`` columns, (2^(32g) mod q, its 64-bit Shoup companion)
    for g < 3, then (2^(8t) mod q, its Shoup companion) for t = 1..7, zero
    where unused. The JAX package keeps the same values per channel as
    u32 pairs."""
    L, nd = ring.num_limbs, ring.num_digits
    t = np.zeros((L, PRESCALE_TABLE_WIDTH), np.uint64)
    t[:, 0] = ring.q
    t[:, 1] = ring.bias_for_columns(C1)
    for g in range((C1 + 3) // 4):
        t[:, 2 + 2 * g], t[:, 3 + 2 * g] = ring.grp_w[:, g], ring.grp_s[:, g]
    for i in range(1, nd):
        t[:, 6 + 2 * i], t[:, 7 + 2 * i] = ring.pow_w[:, i], ring.pow_s64[:, i]
    return t


def _prescale_ntab(ring: "RingPlan", jr: int, device):
    """Scaled twiddle digits of the signed NTT, int8 [L*l, C1, l*jr]:
    entry (ch, c, j*jr + dd) multiplies digit dd of coefficient j into
    NTT column c of channel ch (the banded ``ntt_band_jr`` table, channel
    major)."""
    L, l = ring.num_limbs, ring.degree
    band = ring.table("ntt_band_jr", device, "fwd", jr)           # [L, C1*l, l*jr]
    C1 = band.shape[1] // l
    return band.reshape(L, C1, l, l * jr).permute(0, 2, 1, 3).reshape(L * l, C1, l * jr)


def _prescale_tables(ring: "RingPlan", jr: int, device) -> tuple:
    """(ntab, tabs) of kernel 4 for ``jr`` digit rows: the scaled twiddle
    digits (:func:`_prescale_ntab`, contiguous) and the per-limb constants
    (:func:`_prescale_tabs` of nd + jr - 1 columns), cached per (ring, jr,
    device)."""
    def make(dev):
        global table_builds
        table_builds += 1
        return (_prescale_ntab(ring, jr, dev).contiguous(),
                u.u64_tensor(_prescale_tabs(ring, ring.num_digits + jr - 1), dev))

    return ring.cached(("prescale_tables", jr), device, make)


def ntt_prescale_band_plain(coeffs, ring: "RingPlan", max_abs: int):
    """Plain PyTorch version of :func:`ntt_prescale_band`: the signed NTT
    emitted channel-major, then the scaled-digit band."""
    return prescale_digits_band(ntt_forward_signed_ch(coeffs, ring, max_abs), ring)


def _prescale_fn():
    fn = load(PRESCALE_KERNEL).pvw_ntt_prescale_band
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ntt_prescale_band(coeffs, ring: "RingPlan", max_abs: int):
    """Signed coefficients int32/int64 [k, d, l] (|c| <= max_abs) ->
    scaled-digit band int8 [L, l, nd, k*nd, d], equal to
    ``prescale_digits_band(ntt_forward_signed_ch(coeffs, ring, max_abs))``
    and laid out k-packed: storage [L, l, nd, d, kd_pad] (kd_pad = k*nd
    rounded up to 16), k contiguous, zero pads, handed on as the strided
    view [L, l, nd, k*nd, d].

    CUDA tensors launch ``csrc/ntt_prescale_band.cu`` on the current
    stream (counted in ``ntt_prescale_band.launches``), which writes that
    storage; CPU tensors take :func:`ntt_prescale_band_plain`, whose
    ``prescale_digits_band`` lays its band out the same; anything else
    raises."""
    jr = signed_digit_count(max_abs)
    if not jr:
        raise ValueError(f"coefficients up to {max_abs} need the residue path")
    k, d, l = coeffs.shape
    if l != ring.degree:
        raise ValueError(f"coefficient vectors of length {l}, ring degree {ring.degree}")
    dev = coeffs.device
    if dev.type == "cpu":
        return ntt_prescale_band_plain(coeffs, ring, max_abs)
    if dev.type != "cuda":
        raise ValueError(f"ntt_prescale_band: unsupported device {dev}")
    if l not in PRESCALE_DEGREES:
        raise ValueError(f"ntt_prescale_band: the kernel takes ring degrees "
                         f"{PRESCALE_DEGREES}, got {l}")
    L, nd = ring.num_limbs, ring.num_digits
    x = coeffs.to(torch.int32).contiguous()
    ntab, tabs = _prescale_tables(ring, jr, dev)
    kd = k * nd
    out = torch.empty((L, l, nd, d, -(-kd // 16) * 16), dtype=torch.int8, device=dev)
    _launch(PRESCALE_KERNEL, _prescale_fn(), dev, _ptr(x), _ptr(ntab), _ptr(tabs),
            _ptr(out), L, l, jr, k, d, nd, out.shape[-1])
    ntt_prescale_band.launches += 1
    return out[..., :kd].transpose(-1, -2)


ntt_prescale_band.launches = 0
