"""The two-pass c2 product on a card: ``torch._int_mm`` into int32 digit
columns, then the fold kernel ``fold_only``, against kernel 1.

The counterpart of the JAX package's ``benchmarks/probe_twopass.py``. Pass
1 (:func:`pass1_dot`, the probe's ``pass1_dot``) contracts the lhs digit
planes against the scaled-digit band into the nd int32 columns of every
output, [CH, m, nd, n], in device memory: one ``torch._int_mm`` a channel,
a library call, as XLA's dot was in the JAX probe. Pass 2 (:func:`fold_only`,
the probe's TPU kernel ``fold_only``) folds the columns to canonical
residues with ``csrc/fold_only.cu``; its plain version is
:func:`fold_only_plain`. :func:`main` runs, at the dealer path's c2 shapes:

  A. kernel 1 bare (``matmul_fold_scaled`` with no noise and no encode);
  B. pass 1 alone;
  C. both passes (:func:`two_pass`), and pass 2 alone on B's columns;

checks C == A residue for residue and prints the verdict. Run it on a
card: ``python3 -m pvw_tpu_torch.benchmarks.probe_twopass [toy|config-4]``.
"""

from __future__ import annotations

import ctypes
import sys

import torch

from ..ops import fused_modmat as fm
from ..ops import modmat, u64 as u
from ..ops._build import bind, check_args, launch, ptr
from . import HBM_BYTES_PER_S, INT8_OPS_PER_S, C2_SHAPES, c2_shape, kernel_times, require_card

KERNEL = "fold_only"
ENTRY = (KERNEL, "pvw_fold_only", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def operands(ring, m: int, k: int, n: int, seed: int, device):
    """Random canonical residues made on ``device`` -> (lhs digit planes
    int8 [L, S, m, k*nd], the scaled-digit band int8 [L, S, nd, k*nd, n],
    k-packed as kernel 4 writes it)."""
    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    gen = torch.Generator(device=device).manual_seed(seed)
    q = ring.table("q", device).reshape(L, 1, 1, 1)
    a = torch.randint(0, 1 << 62, (L, S, m, k), generator=gen, device=device) % q
    lhs_dig = modmat.k_rows(modmat.digits(a, nd).reshape(L, S, m, k * nd))
    del a
    b = torch.randint(0, 1 << 62, (L, S, k, n), generator=gen, device=device) % q
    return lhs_dig, modmat.prescale_digits_band(b, ring)


def pass1_dot(lhs_dig, band):
    """Pass 1: lhs digit planes int8 [L, S, m, kd] (or [CH, m, kd]) against
    the scaled-digit band int8 [L, S, nd, kd, n] -> int32 columns
    [CH, m, nd, n], column c the contraction with band plane c (the JAX
    probe's ``pass1_dot``, :func:`~pvw_tpu_torch.ops.modmat.scaled_cols`
    without its final transpose).

    CUDA tensors: one ``torch._int_mm`` a channel (cuBLASLt's int8 GEMM, a
    library call, as the JAX probe left the dot to XLA) writing straight
    into the columns. Its rhs is the band's storage [nd*n, kd] read
    column-major, which a k-packed band with kd a multiple of 16 already is:
    no copy; any other band is copied once, and so is an lhs whose rows are
    not dense, each counted in ``pass1_dot.relayouts``. CPU tensors: the
    exact float64 product of ``modmat.exact_int_matmul``."""
    nd, kd, n = band.shape[-3:]
    ld = lhs_dig.reshape(-1, *lhs_dig.shape[-2:])
    ch, m = ld.shape[:2]
    if ld.shape[-1] != kd or band.numel() != ch * nd * kd * n:
        raise ValueError(f"pass1_dot: lhs {tuple(lhs_dig.shape)} does not match the band "
                         f"{tuple(band.shape)}")
    b = band.reshape(ch, nd, kd, n)
    dev = ld.device
    if dev.type == "cpu":
        r2 = b.permute(0, 2, 1, 3).reshape(ch, kd, nd * n)
        return modmat.exact_int_matmul(ld, r2).reshape(ch, m, nd, n)
    if dev.type != "cuda":
        raise ValueError(f"pass1_dot: unsupported device {dev}")
    rows = b.transpose(-1, -2)                             # [CH, nd, n, kd]
    if not rows.is_contiguous():
        rows = rows.contiguous()
        pass1_dot.relayouts += 1
    if not ld.is_contiguous():
        ld = ld.contiguous()
        pass1_dot.relayouts += 1
    bt = rows.reshape(ch, nd * n, kd)
    cols = torch.empty((ch, m, nd, n), dtype=torch.int32, device=dev)
    flat = cols.view(ch, m, nd * n)
    with torch.cuda.device(dev):
        for c in range(ch):
            torch._int_mm(ld[c], bt[c].t(), out=flat[c])
    return cols


pass1_dot.relayouts = 0


def fold_only_plain(cols, ring):
    """Plain PyTorch version of :func:`fold_only`: the grouped fold of
    ``modmat._fold_leading`` over the same columns."""
    ch, m, nd, n = cols.shape
    L = ring.num_limbs
    per_limb = cols.reshape(L, ch // L, m, nd, n).permute(0, 1, 2, 4, 3)
    return modmat._fold_leading(per_limb, ring).reshape(ch, m, n)


def _fold_tables(ring, S: int, device):
    """The fold kernel's tables int64 [L*S, 8] (``fused_modmat.pack_tables``
    of nd columns, each limb's row repeated for its S channels), cached per
    (ring, S, device)."""
    return ring.cached(("fold_only_tables", S), device, lambda dev: u.u64_tensor(
        fm.pack_tables(ring, ring.num_digits), dev).repeat_interleave(S, dim=0))


def fold_only(cols, ring):
    """Pass 2: int32 digit columns [CH, m, nd, n] (CH = limbs x S channels,
    limb-major; any int32 values) -> canonical residues int64 [CH, m, n],
    out = sum_c 2^(8c) * cols[:, :, c] mod q (the JAX probe's TPU kernel
    ``fold_only``, which returns the (hi, lo) u32 pair of the same values).

    CUDA tensors launch ``csrc/fold_only.cu`` on the current stream (counted
    in ``fold_only.launches``); it takes nd <= 8 and raises otherwise. CPU
    tensors take :func:`fold_only_plain`; any other device raises."""
    ch, m, nd, n = cols.shape
    if nd != ring.num_digits or ch % ring.num_limbs:
        raise ValueError(f"fold_only: columns {tuple(cols.shape)} do not match the ring "
                         f"({ring.num_limbs} limbs, nd = {ring.num_digits})")
    dev = cols.device
    if dev.type == "cpu":
        return fold_only_plain(cols, ring)
    if dev.type != "cuda":
        raise ValueError(f"fold_only: unsupported device {dev}")
    if nd > 8:
        raise ValueError(f"fold_only: the kernel folds at most 8 columns, got nd = {nd}")
    check_args(dev, {"cols": (cols, torch.int32, (ch, m, nd, n))})
    tables = _fold_tables(ring, ch // ring.num_limbs, dev)
    out = torch.empty((ch, m, n), dtype=torch.int64, device=dev)
    launch(KERNEL, bind(*ENTRY), dev, ptr(cols), ptr(tables), ptr(out), ch, m, nd, n)
    fold_only.launches += 1
    return out


fold_only.launches = 0


def two_pass(lhs_dig, band, ring):
    """Both passes: :func:`fold_only` of :func:`pass1_dot` -> residues
    int64 [CH, m, n], the function kernel 1 computes bare."""
    return fold_only(pass1_dot(lhs_dig, band), ring)


def kernel1_bare(lhs_dig, band, ring):
    """A: kernel 1 with no noise and no encode -> residues int64 [CH, m, n]
    (``matmul_fold_scaled``; its plain twin on CPU tensors)."""
    out = fm.matmul_fold_scaled(None, band, ring, lhs_dig=lhs_dig)
    return out.reshape(-1, *out.shape[-2:])


def run(lhs_dig, band, ring) -> dict:
    """The probe's path once: A, then pass 1 (B) and pass 2 on its columns
    (C) -> {"A", "cols", "C", "equal"}: the outputs and whether C == A
    residue for residue."""
    a = kernel1_bare(lhs_dig, band, ring)
    cols = pass1_dot(lhs_dig, band)
    c = fold_only(cols, ring)
    return {"A": a, "cols": cols, "C": c, "equal": bool(torch.equal(a, c))}


def bounds(ring, m: int, k: int, n: int) -> dict:
    """The least times, ms: pass 2 by its bytes (the columns read, the
    residues written), pass 1 by its int8 operations, and both passes by
    the two in turn (the columns written and read back between them)."""
    ch, nd = ring.num_limbs * ring.degree, ring.num_digits
    cols_bytes, out_bytes = 4 * ch * m * nd * n, 8 * ch * m * n
    pass2 = (cols_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    ops = 2 * ch * m * n * k * nd * nd / INT8_OPS_PER_S * 1e3
    return {"pass2_bound_ms": pass2, "pass2_bytes": cols_bytes + out_bytes,
            "int8_bound_ms": ops, "two_pass_bound_ms": ops + pass2}


def times(lhs_dig, band, ring, cols, reps: int = 5) -> dict:
    """CUDA-event medians (ms) and spreads of A, B, C and pass 2 alone on
    ``cols``."""
    out = {}
    for name, fn in (("A", lambda: kernel1_bare(lhs_dig, band, ring)),
                     ("B", lambda: pass1_dot(lhs_dig, band)),
                     ("C", lambda: two_pass(lhs_dig, band, ring)),
                     ("pass2", lambda: fold_only(cols, ring))):
        t = kernel_times(fn, reps)
        out[f"{name}_ms"], out[f"{name}_ms_spread"] = t["ms"], t["ms_spread"]
        torch.cuda.empty_cache()
    return out


def verdict(two_ms: float, fused_ms: float) -> str:
    """The JAX probe's verdict line."""
    word = "WINS — restructure c2" if two_ms < fused_ms else "LOSES — fused kernel stands"
    return f"two-pass {two_ms:.2f} ms vs fused {fused_ms:.2f} ms: {word}"


def main(argv=None) -> int:
    dev = require_card()
    for label in (argv if argv else list(C2_SHAPES)):
        ring, m, k, n = c2_shape(label)
        ch, nd = ring.num_limbs * ring.degree, ring.num_digits
        lhs_dig, band = operands(ring, m, k, n, 0, dev)
        print(f"{label}: CH={ch} m={m} k={k} n={n} nd={nd}; column spill = "
              f"{4 * ch * m * nd * n / 1e9:.2f} GB", flush=True)
        res = run(lhs_dig, band, ring)
        cols = res["cols"]
        del res["A"], res["C"]
        t = times(lhs_dig, band, ring, cols)
        b = bounds(ring, m, k, n)
        print(f"A kernel 1 bare:         {t['A_ms']:8.3f} ms", flush=True)
        print(f"B torch._int_mm (pass 1):{t['B_ms']:8.3f} ms", flush=True)
        print(f"C two-pass (dot + fold): {t['C_ms']:8.3f} ms (bound "
              f"{b['two_pass_bound_ms']:.3f})", flush=True)
        print(f"   pass 2 alone (fold):  {t['pass2_ms']:8.3f} ms (bound "
              f"{b['pass2_bound_ms']:.3f})", flush=True)
        print(f"bit-exact vs kernel 1: {res['equal']}", flush=True)
        if not res["equal"]:
            raise RuntimeError(f"{label}: the two passes differ from kernel 1")
        print(verdict(t["C_ms"], t["A_ms"]), flush=True)
        del lhs_dig, band, cols, res
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
