"""Kernel 1's contraction with a trivial epilogue, in three band layouts:
what the contraction costs on a card without the fold.

The counterpart of the JAX package's ``benchmarks/probe_dot_structure.py``,
whose three TPU kernels (``pallas_dots``, ``pallas_one_dot``,
``pallas_wide_dot``) are the three layouts of :func:`dot_structure`
(``csrc/dot_structure.cu``). For lhs int8 [CH, m, kd] and the nd planes
b_c int8 [kd, D] of a band, each computes int32 [CH, m, D]

    out = p_0 + sum_{c>=1} (p_c >> (c + 1)),    p_c = lhs . b_c

(wrapping, arithmetic shifts), with the band in the JAX probe's layouts:

- ``planes``: the band itself, [CH, nd, kd, D] (probe :65);
- ``one_dot``: :func:`band_one_dot`, [CH, kd, nd, D] (:107);
- ``wide``: :func:`band_wide`, [CH, kd, (D/tn)*nd*tn], nd blocks of tn
  columns a tile of output columns (:141-145).

The card's tensor cores read the band with k innermost, so the kernel
takes each layout stored so (:func:`dot_operand`: the same logical tensor,
a strided view of storage [CH, nd, D, kd] (kernel 1's band), [CH, D, nd,
kd] or [CH, D/tn, nd, tn, kd]); a band of the JAX memory layout is relaid
once, counted in ``dot_structure.relayouts``. :func:`dot_structure_plain`
is the plain version. :func:`main` runs the three at the dealer path's c2
shapes beside ``torch._int_mm`` of the same contraction (the JAX probe's
XLA one-dot floor, :74) and kernel 1 bare. Run it on a card:
``python3 -m pvw_tpu_torch.benchmarks.probe_dot_structure [toy|config-4]``.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import fused_modmat as fm
from ..ops import modmat
from ..ops._build import bind, launch, ptr
from ..ops.u64 import M32
from . import C2_SHAPES, INT8_OPS_PER_S, c2_shape, kernel_times, require_card

KERNEL = "dot_structure"
ENTRY = (KERNEL, "pvw_dot_structure",
         [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
         + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] + [ctypes.c_int] * 7 + [ctypes.c_void_p])
#: the kernel's three entries, in C order
LAYOUTS = ("planes", "one_dot", "wide")
#: the wide layout's block of output columns on a card: one 32-column tile
#: of the kernel (the JAX probe's TN = 128 is its lane tile)
TN = 32


def band_one_dot(band):
    """The band [CH, nd, kd, D] merged along its lanes -> [CH, kd, nd, D]
    (probe_dot_structure.py:107)."""
    return band.permute(0, 2, 1, 3).contiguous()


def band_wide(band, tn: int):
    """The band [CH, nd, kd, D] interleaved in blocks of ``tn`` columns ->
    [CH, kd, (D/tn)*nd*tn]: for output block jb, the nd planes' tn columns
    side by side (probe_dot_structure.py:141-145)."""
    ch, nd, kd, d = band.shape
    return (band.reshape(ch, nd, kd, d // tn, tn).permute(0, 2, 3, 1, 4)
            .reshape(ch, kd, (d // tn) * nd * tn))


def band_layout(band, layout: str, tn: int = TN):
    """The band [CH, nd, kd, D] in ``layout``'s JAX layout."""
    if layout == "planes":
        return band
    if layout == "one_dot":
        return band_one_dot(band)
    if layout == "wide":
        return band_wide(band, tn)
    raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")


def _planes(lhs, band_x, layout: str, tn: int, nd):
    """The nd int32 columns p_c [CH, m, D] of the contraction."""
    ch, m, kd = lhs.shape
    if layout == "planes":
        p = modmat.exact_int_matmul(lhs[:, None], band_x)                 # [CH, nd, m, D]
        return [p[:, c] for c in range(p.shape[1])]
    if layout == "one_dot":
        nd, d = band_x.shape[2:]
        p = modmat.exact_int_matmul(lhs, band_x.reshape(ch, kd, nd * d)).reshape(ch, m, nd, d)
        return [p[:, :, c] for c in range(nd)]
    if layout == "wide":
        d = band_x.shape[-1] // nd
        p = modmat.exact_int_matmul(lhs, band_x).reshape(ch, m, d // tn, nd, tn)
        return [p[:, :, :, c].reshape(ch, m, d) for c in range(nd)]
    raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")


def dot_structure_plain(lhs, band_x, layout: str, tn: int = TN, nd=None):
    """Plain PyTorch version of :func:`dot_structure`: the exact products of
    ``modmat.exact_int_matmul``, then the shifted sum in int64, wrapped to
    int32."""
    p = _planes(lhs, band_x, layout, tn, nd)
    acc = p[0].to(torch.int64)
    for c in range(1, len(p)):
        acc = acc + (p[c] >> (c + 1)).to(torch.int64)
    acc = (acc + (1 << 31)) & M32
    return (acc - (1 << 31)).to(torch.int32)


def _rows(band_x, layout: str):
    """``band_x`` (``layout``'s logical shape) as the rows the kernel reads,
    k last: [CH, nd, D, kd], [CH, D, nd, kd] or [CH, W, kd]. Its own inverse."""
    return band_x.permute(0, 3, 2, 1) if layout == "one_dot" else band_x.transpose(-1, -2)


def dot_operand(band_x, layout: str):
    """``band_x`` in ``layout``'s logical shape, stored as the kernel reads
    it: k contiguous, every other stride and the base on 16 bytes
    (``modmat.k_rows_ok`` of its rows). ``band_x`` itself when it lies so
    (kernel 1's k-packed band does, as the planes layout); else one copy into
    that storage, counted in ``dot_structure.relayouts``."""
    rows = _rows(band_x, layout)
    if modmat.k_rows_ok(rows):
        return band_x
    dot_structure.relayouts += 1
    return _rows(modmat.k_rows(rows), layout)


def dot_structure(lhs, band_x, layout: str, tn: int = TN, nd=None):
    """lhs int8 [CH, m, kd] against the band ``band_x`` in ``layout`` (see
    the module; ``nd`` is needed for ``wide``, whose shape does not give it)
    -> int32 [CH, m, D], p_0 + sum_{c>=1} (p_c >> (c + 1)).

    CUDA tensors launch ``csrc/dot_structure.cu`` on the current stream,
    counted per layout in ``dot_structure.<layout>_launches``; the band and
    lhs are laid out first where they do not lie as the kernel reads them
    (:func:`dot_operand`, ``modmat.k_rows``), each copy counted in
    ``dot_structure.relayouts``. The kernel takes nd <= 8 and, for ``wide``,
    tn a multiple of 32. CPU tensors take :func:`dot_structure_plain`; any
    other device raises."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of {LAYOUTS}")
    if layout == "wide" and nd is None:
        raise ValueError("dot_structure: the wide layout needs nd")
    dev = lhs.device
    if dev.type == "cpu":
        return dot_structure_plain(lhs, band_x, layout, tn, nd)
    if dev.type != "cuda":
        raise ValueError(f"dot_structure: unsupported device {dev}")
    ch, m, kd = lhs.shape
    rows = _rows(dot_operand(band_x, layout), layout)
    if layout == "planes":
        nd, d = rows.shape[1:3]
    elif layout == "one_dot":
        d, nd = rows.shape[1:3]
    else:
        d = rows.shape[1] // nd
        if tn % 32 or d % tn:
            raise ValueError(f"dot_structure: the wide kernel takes tn a multiple of 32 "
                             f"dividing D = {d}, got {tn}")
        rows = rows.reshape(ch, d // tn, nd, tn, kd)
    if rows.shape[0] != ch or rows.shape[-1] != kd or nd > 8:
        raise ValueError(f"dot_structure: band {tuple(band_x.shape)} does not match lhs "
                         f"{tuple(lhs.shape)} (nd <= 8)")
    if not modmat.k_rows_ok(lhs):
        lhs = modmat.k_rows(lhs)
        dot_structure.relayouts += 1
    fm.check_operands(dev, {"lhs": (lhs, (ch, m, kd)), "band": (rows, tuple(rows.shape))})
    lhs_ch, lhs_row = modmat.operand_strides(lhs)
    strides = modmat.operand_strides(rows)[::-1] + [0] * (5 - rows.dim())
    out = torch.empty((ch, m, d), dtype=torch.int32, device=dev)
    launch(KERNEL, bind(*ENTRY), dev, ptr(lhs), lhs_row, lhs_ch, ptr(rows), *strides, ptr(out),
           LAYOUTS.index(layout), ch, m, d, kd, nd, tn)
    name = f"{layout}_launches"
    setattr(dot_structure, name, getattr(dot_structure, name) + 1)
    return out


dot_structure.relayouts = 0
for _layout in LAYOUTS:
    setattr(dot_structure, f"{_layout}_launches", 0)
del _layout


def operands(ch: int, m: int, kd: int, nd: int, d: int, seed: int, device):
    """The JAX probe's random operands made on ``device``: lhs int8
    [CH, m, kd] and a band int8 [CH, nd, kd, D], both in [-64, 64), the
    band stored k-packed as kernel 1 reads it (storage [CH, nd, D, kd_pad])."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lhs = modmat.k_rows(torch.randint(-64, 64, (ch, m, kd), generator=gen, device=device,
                                      dtype=torch.int8))
    rows = modmat.k_rows(torch.randint(-64, 64, (ch, nd, d, kd), generator=gen,
                                       device=device, dtype=torch.int8))
    return lhs, rows.transpose(-1, -2)


def int_mm(lhs, band):
    """One ``torch._int_mm`` a channel of the same contraction (lhs [m, kd]
    against the nd planes side by side, the rhs column-major as cuBLASLt
    takes it, read from the k-packed band's storage where kd_pad = kd): the
    int32 products p_c, no combine. The JAX probe's one-dot floor."""
    ch, m, kd = lhs.shape
    nd, d = band.shape[1], band.shape[3]
    bt = band.transpose(-1, -2).reshape(ch, nd * d, kd)
    out = torch.empty((ch, m, nd * d), dtype=torch.int32, device=lhs.device)
    for c in range(ch):
        torch._int_mm(lhs[c], bt[c].t(), out=out[c])
    return out


def main(argv=None) -> int:
    dev = require_card()
    for label in (argv if argv else list(C2_SHAPES)):
        ring, m, k, n = c2_shape(label)
        L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
        ch, kd = L * S, k * nd
        lhs, band = operands(ch, m, kd, nd, n, 0, dev)
        macs = ch * m * kd * nd * n
        print(f"{label}: CH={ch} m={m} kd={kd} nd={nd} D={n}; int8 bound "
              f"{2 * macs / INT8_OPS_PER_S * 1e3:.3f} ms", flush=True)
        t = kernel_times(lambda: int_mm(lhs, band))
        print(f"torch._int_mm one-dot floor:        {t['ms']:8.3f} ms -> "
              f"{macs / t['ms'] / 1e9:.1f} T MAC/s", flush=True)
        t = kernel_times(lambda: fm.matmul_fold_scaled(
            None, band.reshape(L, S, nd, kd, n), ring, lhs_dig=lhs.reshape(L, S, m, kd)))
        print(f"kernel 1 bare (fold):               {t['ms']:8.3f} ms -> "
              f"{macs / t['ms'] / 1e9:.1f} T MAC/s", flush=True)
        for layout in LAYOUTS:
            laid = dot_operand(band_layout(band, layout), layout)
            t = kernel_times(lambda: dot_structure(lhs, laid, layout, TN, nd))
            print(f"dot_structure {layout:8s} (no fold):   {t['ms']:8.3f} ms -> "
                  f"{macs / t['ms'] / 1e9:.1f} T MAC/s", flush=True)
            del laid
            torch.cuda.empty_cache()
        del lhs, band
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
