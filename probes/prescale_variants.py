#!/usr/bin/env python3
"""Time variants of kernel 4 (``csrc/ntt_prescale_band.cu``) against the
committed source.

Run from the root of the repository on a machine with an NVIDIA H100:

    python3 probes/prescale_variants.py [--baseline SOURCE] [variant ...]

Each variant is the committed kernel with some lines of its source
rewritten (``VARIANTS`` below; no names: all of them). Every source is
built with nvcc (all at once, ``-Xptxas -v``: registers and spills a
kernel) into ``build/prescale_variants`` and launched raw, on inputs made
once, at the toy chain's r shape (16 channels, k = 256, d = 4096, nd = 5)
and config 4's (272 channels, k = 512, d = 1024, nd = 8), jr = 1. Each
round times every build once (ten launches between two CUDA events, the
time a launch), the builds in turn, so that they share the card's state;
the median over the rounds, with the spread. Every build's band is held
against the committed kernel's, byte for byte (pads included). The
committed wrapper ``fused_modmat.ntt_prescale_band`` (its tables cached
per ring, as ``chip_smoke.py`` times it) is timed beside them.
``shuffle_gather`` (``probes/prescale_shuffle.cu``) and ``lane16``
(``probes/prescale_lane16.cu``) are whole sources with the committed
entry: the two ways to store where nd does not divide 16 without staging
bytes in shared memory.

``--baseline SOURCE``: an n-major form of the kernel (entry
``pvw_ntt_prescale_band(coeffs, ntab, tabs, out, L, deg, jr, k, d, nd,
stream)``, writing [CH, nd, k*nd, d]), built and timed in the same rounds;
its band is held against the committed one's values. The ablations
``no_stores``, ``no_stage`` and ``coalesced_coeffs`` compute wrong bands
on purpose: they show what bounds the kernel. One JSON line per build and
per timing.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "pvw_tpu_torch" / "csrc"
SOURCE = "ntt_prescale_band.cu"
SEG = "  __shared__ __align__(16) uint8_t seg[WY * QY][8 * KX];\n"
GATHER = ("          uint8_t* mine = my + threadIdx.x * nd;\n"
          "#pragma unroll\n"
          "          for (int b = 0; b < 8; ++b)\n"
          "            if (b < nd) mine[b] = (uint8_t)((b < 4 ? wl[j] : wh[j]) >> (8 * (b & 3)));\n")
STAGED = (GATHER +
          "          __syncwarp();\n"
          "          if ((int)threadIdx.x < chunks)\n"
          "            reinterpret_cast<uint4*>(p)[threadIdx.x] = "
          "reinterpret_cast<const uint4*>(my)[threadIdx.x];\n"
          "          __syncwarp();\n"
          "        }\n"
          "      }\n")
# the staged stores batched: every digit plane's bytes of a (slot, column)
# gathered first, then all their 16-byte chunks, two warp syncs a column
# and slot instead of two a plane
BATCH = [(SEG, "  __shared__ __align__(16) uint8_t seg[WY * QY][8 * 8 * KX];\n"),
         (STAGED,
          GATHER.replace("my + threadIdx.x * nd", "my + j * KX * nd + threadIdx.x * nd") +
          "        }\n"
          "      }\n"
          "      if (!direct) {\n"
          "        __syncwarp();\n"
          "        for (int i = threadIdx.x; i < nd * chunks; i += KX) {\n"
          "          const int j = i / chunks, q = i % chunks;\n"
          "          reinterpret_cast<uint4*>(row + (size_t)j * plane)[q] =\n"
          "              reinterpret_cast<const uint4*>(my + j * KX * nd)[q];\n"
          "        }\n"
          "        __syncwarp();\n"
          "      }\n")]
MIN_BLOCKS = ("__global__ void __launch_bounds__(THREADS)\n",
              "__global__ void __launch_bounds__(THREADS, 4)\n")
CX_AT = lambda cx: ("constexpr int CX = 1; ", f"constexpr int CX = {cx}; ")
SLOTS_UNROLL2 = ("#pragma unroll 1\n  for (int s = 0; s < DEG; ++s) {",
                 "#pragma unroll 2\n  for (int s = 0; s < DEG; ++s) {")
# the gather's byte stores as the previous source had them: a loop over nd
# with a 64-bit shift by a runtime amount
LOOPED_GATHER = (GATHER, "          for (int b = 0; b < nd; ++b) my[threadIdx.x * nd + b] = "
                         "(uint8_t)(word >> (8 * b));\n")
# no gather: each lane stores its nd bytes straight to the band row (byte
# stores, the warp's 32 * nd bytes contiguous; none past the padded row)
DIRECT_BYTES = (STAGED,
                "          int8_t* pw = p + threadIdx.x * nd;\n"
                "#pragma unroll\n"
                "          for (int b = 0; b < 8; ++b)\n"
                "            if (b < nd && kk * nd + b < kd_pad)\n"
                "              pw[b] = (int8_t)((b < 4 ? wl[j] : wh[j]) >> (8 * (b & 3)));\n"
                "        }\n      }\n")
VARIANTS = {
    "looped_gather": {SOURCE: [LOOPED_GATHER]},
    "direct_bytes": {SOURCE: [DIRECT_BYTES]},
    "batch_j": {SOURCE: BATCH},
    "min_blocks4": {SOURCE: [MIN_BLOCKS]},
    "batch_j_min_blocks4": {SOURCE: [*BATCH, MIN_BLOCKS]},
    # two or four columns a thread (independent chains of Shoup products)
    "cx2": {SOURCE: [CX_AT(2)]},
    "cx4": {SOURCE: [CX_AT(4)]},
    # two slots in flight a thread
    "slots_unroll2": {SOURCE: [SLOTS_UNROLL2]},
    # the ablations: everything computed, nothing stored; nor gathered in
    # shared memory (the staged path, nd not dividing 16)
    "no_stage": {SOURCE: [(STAGED, "          if (kd_pad < 0) my[threadIdx.x] = (uint8_t)word;\n"
                                   "        }\n      }\n")]},
    # the coefficient loads coalesced (lanes on neighbouring vectors of
    # the wrong rows): what the k-row lanes' strided loads cost
    "coalesced_coeffs": {SOURCE: [(
        "coeffs + ((size_t)kk * d + col0 + c) * DEG);",
        "coeffs + ((size_t)(col0 + c) * k + kk) * DEG);")]},
    "no_stores": {SOURCE: [
        ("            if (nd == 8) *reinterpret_cast<uint64_t*>(pw) = word;",
         "            if (kd_pad < 0) *reinterpret_cast<uint64_t*>(pw) = word;"),
        ("          if ((int)threadIdx.x < chunks)\n",
         "          if ((int)threadIdx.x < chunks && kd_pad < 0)\n")]},
}
ABLATIONS = ("no_stage", "no_stores", "coalesced_coeffs")
# whole-source variants with the committed entry: the store path where nd
# does not divide 16 without shared memory, (a) as warp shuffles
# (``shuffle_gather``, any shape) or (b) with lanes that own 16 k rows, so
# that each stores nd whole 16-byte chunks a plane (``lane16``, the probe's
# two r shapes only)
WHOLE = {"shuffle_gather": ROOT / "probes" / "prescale_shuffle.cu",
         "lane16": ROOT / "probes" / "prescale_lane16.cu"}


def variant_dir(name: str, edits: dict) -> Path:
    """build/prescale_variants/<name>/ holding the kernel source and the
    shared headers, with ``edits`` applied."""
    out = ROOT / "build" / "prescale_variants" / name
    out.mkdir(parents=True, exist_ok=True)
    for path in [CSRC / SOURCE, *CSRC.glob("*.cuh")]:
        text = path.read_text()
        for old, new in edits.get(path.name, []):
            if old not in text:
                raise RuntimeError(f"variant text not in {path.name}: {old!r}")
            text = text.replace(old, new)
        (out / path.name).write_text(text)
    return out


def build(srcs: dict) -> dict:
    """name -> loaded library of source path ``srcs[name]``, every source
    compiled at once."""
    from pvw_tpu_torch.ops import _build

    procs = {}
    for name, src in srcs.items():
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
               "-o", str(src.with_suffix(".so")), str(src)]
        procs[name] = (src, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, proc) in procs.items():
        log, _ = proc.communicate()
        cs.emit({"variant": name, "nvcc_rc": proc.returncode,
                 "registers": re.findall(r"Used (\d+) registers", log),
                 "spill_bytes": re.findall(r"(\d+) bytes spill stores", log)})
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(src.with_suffix(".so")))
    return libs


def main(argv) -> int:
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", type=Path)
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("variants", nargs="*")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("prescale_variants: no CUDA card", file=sys.stderr)
        return 2
    shutil.rmtree(ROOT / "build" / "prescale_variants", ignore_errors=True)
    srcs = {"committed": variant_dir("committed", {}) / SOURCE}
    names = args.variants or [*VARIANTS, *WHOLE]
    srcs |= {n: variant_dir(n, VARIANTS[n]) / SOURCE for n in names if n in VARIANTS}
    for n in (n for n in names if n in WHOLE):
        srcs[n] = variant_dir(n, {}) / SOURCE
        shutil.copy(WHOLE[n], srcs[n])
    if args.baseline is not None:
        base = ROOT / "build" / "prescale_variants" / "n_major"
        base.mkdir(parents=True, exist_ok=True)
        shutil.copy(args.baseline, base / SOURCE)
        srcs["n_major"] = base / SOURCE
    libs = build(srcs)
    dev = torch.device("cuda")
    card = cs.card_line()
    shapes = [("toy r", get_ring(cs.MODULI, cs.ELL), cs.K_DIM, cs.N_RECEIVERS),
              ("config-4 r", get_ring(generate_ntt_primes(61, 17, cs.DEEP_ELL), cs.DEEP_ELL),
               cs.DEEP_K, cs.DEEP_N)]
    stream = torch.cuda.current_stream()
    for label, ring, k, d in shapes:
        L, l, nd = ring.num_limbs, ring.degree, ring.num_digits
        gen = torch.Generator(device=dev).manual_seed(7)
        c = cs.r_coeffs(k, d, l, 1, gen, dev).to(torch.int32).contiguous()
        ntab, tabs = fm._prescale_tables(ring, 1, dev)
        kd = k * nd
        kd_pad = -(-kd // 16) * 16
        # the committed kernel's band, then one output for the k-packed
        # builds and one for the n-major one (a band is 9.1 GB at config 4)
        ref = torch.full((L * l, nd, d, kd_pad), 99, dtype=torch.int8, device=dev)
        out_k = torch.full_like(ref, 99)
        out_n = torch.full((L * l, nd, kd, d), 99, dtype=torch.int8, device=dev) \
            if "n_major" in libs else None
        calls = {}
        for name, lib in libs.items():
            fn = lib.pvw_ntt_prescale_band
            fn.restype = ctypes.c_int
            n_major = name == "n_major"
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (6 if n_major else 7) \
                + [ctypes.c_void_p]
            out = out_n if n_major else ref if name == "committed" else out_k
            tail = (L, l, 1, k, d, nd) if n_major else (L, l, 1, k, d, nd, kd_pad)
            argv_ = (fm._ptr(c), fm._ptr(ntab), fm._ptr(tabs), fm._ptr(out), *tail,
                     ctypes.c_void_p(stream.cuda_stream))

            def call(fn=fn, argv_=argv_):
                if fn(*argv_) != 0:
                    raise RuntimeError("launch failed")
            calls[name] = call
        calls["committed"]()
        for name, call in calls.items():
            if name == "committed" or name in ABLATIONS:
                continue
            call()
            got = out_n.transpose(-1, -2) if name == "n_major" else out_k
            if not torch.equal(got, ref[..., :kd] if name == "n_major" else ref):
                raise RuntimeError(f"{name}'s band differs from the committed kernel's at {label}")
        calls["wrapper"] = lambda: fm.ntt_prescale_band(c, ring, 1)
        times = {name: [] for name in calls}
        for _ in range(args.rounds):
            for name, call in calls.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call()
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 10)
        for name, t in times.items():
            cs.emit({"shape": label, "variant": name, "card": card,
                     "ms": statistics.median(t), "ms_spread": [min(t), max(t)],
                     "bit_exact": None if name in ABLATIONS or name == "wrapper" else True})
        del c, ref, out_k, out_n
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
