#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and hold its kernel
against the plain version.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and exits non-zero:

1. device: the card (``nvidia-smi`` name and power limit) and the kernel
   build from ``pvw_tpu_torch/csrc`` (nvcc, into ``build/kernels``);
2. kernel_vs_plain: the fused scaled-noise matmul against its plain
   PyTorch twin at the keygen, c1 and c2 shapes of the main path at a
   dealer batch of 512 (CH=16, kd=1280, nd=5), with jr=1/2 noise planes,
   value and digit noise rows, the 32-bit encode and the 64-bit encode
   with scalars around 2^63: bit-exact;
3. timing: kernel, plain twin and ``torch._int_mm`` (the int8 contraction
   alone, a yardstick the port never calls) at the full c2 shape
   (m = n = 4096), CUDA events, median of several runs;
4. golden: the golden system of tests/test_golden.py on the card must give
   its five pinned hashes;
5. main_path: n = 4096 receivers, k = 256, l = 8, the 2-limb chain: CRS,
   batch keygen, 4096 dealers' shares encrypted in one batch, four parties'
   shares decrypted exactly, and one encryption with scalars >= 2^63
   decrypted with the reference's `as i64` semantics; the kernel's launch
   count over this phase;
6. breakdown: the stages of one full-width encryption and decryption,
   each timed alone;
7. the kernels line, then the last line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and dense int8 rate
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15

N_RECEIVERS, K_DIM, ELL = 4096, 256, 8
MODULI = (0xFFFFC4001, 0x1FFFFE0001)
COMPARE_BATCH = 512
GOLDEN_MODULI = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)
GOLDEN = {"crs": "87295f5306ea364d", "secret_key": "d3bc51f25628c4f5",
          "global_pk": "8d40adf52c1c9af2", "c1": "9c7654078768ba8f",
          "c2": "2d627fd108fc81bd"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def operands(ring, m, k, n, jr, encode, gen, dev):
    """Random operands of one fused-matmul call, made on the card."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm, modmat, ntt, u64

    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    q = ring.table("q", dev).reshape(L, 1, 1, 1)
    a = torch.randint(0, 1 << 62, (L, S, m, k), generator=gen, device=dev) % q
    b = torch.randint(0, 1 << 62, (L, S, k, n), generator=gen, device=dev) % q
    lhs_dig = modmat.digits(a, nd).reshape(L, S, m, k * nd)
    band = modmat.prescale_digits_band(b, ring)
    bound = 50 if jr == 1 else 2000
    ev = torch.randint(-bound, bound + 1, (m, n, S), generator=gen, device=dev,
                       dtype=torch.int32)
    noise = ntt._digit_planes(ev, jr)
    enc = None
    if encode:
        hi, lo = (torch.randint(0, 1 << 32, (m, n), generator=gen, device=dev)
                  for _ in range(2))
        sc = (hi << 32) | lo
        if encode == "enc32":
            sc &= 0xFFFFFFFF
        else:
            sc[0, :4] = torch.tensor([0, -(1 << 63), -1, (1 << 63) - 1], device=dev)
        g = np.random.default_rng(0).integers(0, 1 << 62, (L, S), dtype=np.uint64)
        g %= ring.q[:, None]
        gs = np.array([[(int(g[i, s]) << 64) // qi for s in range(S)]
                       for i, qi in enumerate(ring.moduli)], object)
        wrap = np.array([[pow(2, 64, qi) * int(g[i, s]) % qi for s in range(S)]
                         for i, qi in enumerate(ring.moduli)], np.uint64)
        etab = fm.encode_tab(g, (gs & 0xFFFFFFFFFFFFFFFF).astype(np.uint64), wrap)
        enc = (sc, u64.u64_tensor(etab, dev))
    return lhs_dig, band, noise, bound, enc


def phase_kernel_vs_plain(ring, dev) -> int:
    import torch

    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm

    gen = torch.Generator(device=dev).manual_seed(1)
    d = COMPARE_BATCH
    cases = [("keygen", N_RECEIVERS, K_DIM, 1, None, True),
             ("keygen", N_RECEIVERS, K_DIM, 2, None, False),
             ("c1", K_DIM, d, 1, None, True),
             ("c1", K_DIM, d, 2, None, True),
             ("c2", N_RECEIVERS, d, 1, "enc32", True),
             ("c2", N_RECEIVERS, d, 2, "enc64", False)]
    worst = 0
    for name, m, n, jr, encode, vals in cases:
        lhs_dig, band, noise, bound, enc = operands(ring, m, K_DIM, n, jr, encode, gen, dev)
        settings.noise_value_mac = vals
        try:
            got = fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc,
                                        lhs_dig=lhs_dig, encode32=encode == "enc32",
                                        noise_bound=bound)
        finally:
            del settings.noise_value_mac
        want = fm.matmul_fold_scaled_plain(None, band, ring, noise=noise, encode=enc,
                                           lhs_dig=lhs_dig)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        worst = max(worst, err)
        emit({"phase": "kernel_vs_plain", "shape": name, "m": m, "n": n,
              "kd": lhs_dig.shape[-1], "channels": 16, "jr": jr,
              "noise_rows": "values" if vals else "digits",
              "encode": encode or "none", "bit_exact": bool(torch.equal(got, want)),
              "max_abs_err": err})
        check(torch.equal(got, want), f"kernel differs from the plain twin at {name}")
        del lhs_dig, band, noise, enc, got, want
    torch.cuda.empty_cache()
    return worst


def phase_timing(ring, dev, card: str) -> dict:
    """Kernel, plain twin and torch._int_mm at the full c2 shape."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm

    gen = torch.Generator(device=dev).manual_seed(2)
    m = n = N_RECEIVERS
    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    lhs_dig, band, noise, bound, enc = operands(ring, m, K_DIM, n, 1, "enc32", gen, dev)
    kd = lhs_dig.shape[-1]

    def kernel():
        return fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc,
                                     lhs_dig=lhs_dig, encode32=True, noise_bound=bound)

    def plain():
        return fm.matmul_fold_scaled_plain(None, band, ring, noise=noise, encode=enc,
                                           lhs_dig=lhs_dig)

    got = kernel()
    want = plain()
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(err == 0, "kernel differs from the plain twin at the full c2 shape")
    del got, want
    torch.cuda.empty_cache()
    ms = cuda_ms(kernel, reps=5)
    plain_ms = cuda_ms(plain, reps=3)
    torch.cuda.empty_cache()
    a = lhs_dig.reshape(L * S, m, kd).contiguous()
    # the rhs column-major ([nd*n, kd] rows, transposed), as cuBLASLt's
    # int8 GEMM takes it
    bt = band.reshape(L * S, nd, kd, n).permute(0, 1, 3, 2).reshape(L * S, nd * n, kd).contiguous()

    def library():
        return [torch._int_mm(a[c], bt[c].t()) for c in range(L * S)]

    library_ms = cuda_ms(library, reps=5)
    macs = L * S * m * n * kd * nd
    nbytes = (lhs_dig.numel() + band.numel() + noise.numel() + 8 * m * n
              + 8 * L * S * m * n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * macs / INT8_OPS_PER_S * 1e3
    out = {"phase": "timing", "shape": f"c2 m={m} n={n} channels={L * S} kd={kd} nd={nd}",
           "card": card, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
           "bytes": nbytes, "int8_macs": macs, "max_abs_err": err}
    emit(out)
    del lhs_dig, band, noise, enc, a, bt
    torch.cuda.empty_cache()
    return out


def phase_golden(dev) -> None:
    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R

    b1, b2 = P.PvwParameters.suggest_error_bounds(4, 8, 8, GOLDEN_MODULI, 0.5)
    p = (P.PvwParametersBuilder().set_parties(4).set_dimension(8).set_l(8)
         .set_moduli(GOLDEN_MODULI).set_secret_variance(0.5)
         .set_error_bounds_u32(b1, b2).build())
    key = R.key(1234)
    crs = P.PvwCrs.new_deterministic(p, bytes(range(32)), device=dev)
    parties = [P.Party.new(i, p, R.fold_in(key, i), device=dev) for i in range(4)]
    gpk = P.GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, R.fold_in(key, 99))
    ct = P.encrypt_batch(np.arange(8, dtype=np.uint64).reshape(2, 4), gpk, R.fold_in(key, 7))

    def h(arr):
        return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]

    got = {"crs": h(crs.matrix.residues_np()),
           "secret_key": h(np.stack([pt.secret_key.secret_coeffs for pt in parties])),
           "global_pk": h(gpk.matrix.residues_np()),
           "c1": h(ct.c1.residues_np()), "c2": h(ct.c2.residues_np())}
    emit({"phase": "golden", "hashes": got, "ok": got == GOLDEN})
    check(got == GOLDEN, f"golden hashes differ: {got}")


def expected_wrapped(m: int, q: int) -> int:
    """What the reference decodes for scalar m encoded as ``m as i64``
    (encryption.rs:195, decryption.rs:226-247), with no residual noise."""
    from pvw_tpu_torch.utils.intmath import center_mod

    signed = m - (1 << 64) if m >= 1 << 63 else m
    mf = center_mod(signed % q, q)
    if mf < 0:
        if -mf <= 1000:
            return 0
        pos = (mf + q) % q
        return pos if pos < 1 << 64 else 0
    return mf if mf < 1 << 64 else 0


def phase_main_path(dev, card: str) -> dict:
    import torch

    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.ops import fused_modmat as fm

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    b1, b2 = P.PvwParameters.suggest_error_bounds(N_RECEIVERS, K_DIM, ELL, MODULI, 0.5)
    params = (P.PvwParametersBuilder().set_parties(N_RECEIVERS).set_dimension(K_DIM)
              .set_l(ELL).set_moduli(MODULI).set_secret_variance(0.5)
              .set_error_bounds_u32(b1, b2).build())
    key = R.key(0)
    rng = np.random.default_rng(0)
    shares = rng.integers(0, 1 << 32, size=(N_RECEIVERS, N_RECEIVERS), dtype=np.uint64)
    wrap_sc = rng.integers(0, 1 << 32, size=N_RECEIVERS, dtype=np.uint64)
    wrap_sc[::2] |= np.uint64(1 << 63)
    parties = (0, 1, N_RECEIVERS // 2 - 1, N_RECEIVERS - 1)
    wrap_parties = (0, 1, N_RECEIVERS // 2, N_RECEIVERS - 1)   # two >= 2^63
    torch.cuda.reset_peak_memory_stats()

    fm.fused_scaled_noise_matmul.launches = 0
    crs, crs_ms = timed(lambda: P.PvwCrs.new(params, R.fold_in(key, 0), device=dev))
    coeffs = P.sample_vec_cbd(R.fold_in(key, 10_000), (N_RECEIVERS, K_DIM, ELL),
                              params.secret_variance, device=dev)
    gpk = P.GlobalPublicKey(crs)
    _, keygen_ms = timed(lambda: gpk.generate_all_keys_device(coeffs, R.fold_in(key, 1)))
    _, operands_ms = timed(gpk.encrypt_operands)
    ct, encrypt_ms = timed(lambda: P.encrypt_all_party_shares_batched(
        shares, gpk, R.fold_in(key, 777)))
    host_coeffs = coeffs.cpu().numpy()
    sks = {i: P.SecretKey(params, host_coeffs[i]) for i in parties + wrap_parties}
    t0 = time.perf_counter()
    got = {i: P.decrypt_party_shares(ct, sks[i], i) for i in parties}
    decrypt_ms = (time.perf_counter() - t0) * 1e3
    wrap_ct, wrap_encrypt_ms = timed(lambda: P.encrypt(wrap_sc, gpk, R.fold_in(key, 778)))
    wrap_got = {i: P.decrypt_party_value(wrap_ct, sks[i], i) for i in wrap_parties}
    launches = fm.fused_scaled_noise_matmul.launches

    shares_exact = all(got[i] == [int(v) for v in shares[:, i]] for i in parties)
    q = params.q_total()
    wrap_ok = all(wrap_got[i] == expected_wrapped(int(wrap_sc[i]), q) for i in wrap_parties)
    out = {"phase": "main_path", "card": card, "n": N_RECEIVERS, "k": K_DIM, "l": ELL,
           "moduli": [hex(m) for m in MODULI], "error_bounds": [b1, b2],
           "dealers": N_RECEIVERS, "crs_ms": crs_ms, "keygen_ms": keygen_ms,
           "operands_ms": operands_ms, "encrypt_ms": encrypt_ms,
           "enc_per_s": N_RECEIVERS / (encrypt_ms / 1e3),
           "decrypt_ms": decrypt_ms, "decrypt_parties": list(parties),
           "shares_exact": shares_exact, "wrap_encrypt_ms": wrap_encrypt_ms,
           "wrap_scalars": {str(i): int(wrap_sc[i]) for i in wrap_parties},
           "wrap_decoded": {str(i): wrap_got[i] for i in wrap_parties},
           "wrap_ok": wrap_ok, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    check(shares_exact, "a decrypted share differs from the encrypted one")
    check(wrap_ok, "the >= 2^63 scalars did not decode with `as i64` semantics")
    check(launches >= 3, f"the kernel ran {launches} times on the main path")
    return out, {"params": params, "gpk": gpk, "shares": shares, "sk": sks[parties[0]]}


def phase_breakdown(dev, card: str, ctx) -> dict:
    """The stages of one full-width encryption and decryption, each timed
    alone (host clock around work ending in a synchronize): where the
    main path's time goes. Same calls as ``encryption._encrypt_kernel``."""
    import torch

    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.crypto import decryption
    from pvw_tpu_torch.ops import fused_modmat as fm, modmat, ntt, u64
    from pvw_tpu_torch.sampling.cbd import sample_vec_cbd_rows

    params, gpk, shares = ctx["params"], ctx["gpk"], ctx["shares"]
    ring, k, n, l = params.ring, params.k, params.n, params.l
    d = shares.shape[0]
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    k_r, k_e1, k_e2 = R.split(R.fold_in(R.key(0), 779), 3)
    sc = timed("scalars_to_device_ms", lambda: u64.u64_tensor(shares, dev))
    r = timed("r_sample_ms", lambda: sample_vec_cbd_rows(k_r, 0, k, (d, l), 0.5, dev))
    r_ch = timed("r_ntt_ms", lambda: ntt.ntt_forward_signed_ch(r, ring, 1))
    r_op = timed("r_prescale_ms", lambda: modmat.prescale_digits_band(r_ch, ring))
    n1 = timed("noise_c1_ms", lambda: ntt.noise_digit_planes(
        k_e1, 0, k, d, l, params.error_bound_1, dev))
    n2 = timed("noise_c2_ms", lambda: ntt.noise_digit_planes(
        k_e2, 0, n, d, l, params.error_bound_2, dev))
    a_dig, b_dig = gpk.encrypt_operands()
    etab = u64.u64_tensor(fm.encode_tab(params.gadget_ntt, params.gadget_ntt_shoup,
                                        params.gadget_wrap), dev)
    c1 = timed("kernel_c1_ms", lambda: fm.matmul_fold_scaled(
        None, r_op, ring, noise=n1, lhs_dig=a_dig, noise_bound=params.error_bound_1))
    c2 = timed("kernel_c2_ms", lambda: fm.matmul_fold_scaled(
        None, r_op, ring, noise=n2, encode=(sc.t().contiguous(), etab), lhs_dig=b_dig,
        encode32=True, noise_bound=params.error_bound_2))
    sk = ctx["sk"].to_polynomials(dev).res
    z = timed("decrypt_contract_ntt_ms", lambda: decryption._noisy_messages(
        params, sk, c1, c2[:, :, 0]))
    timed("decode_python_ms", lambda: decryption._decode_batch(z, params))
    out = {"phase": "breakdown", "card": card, "dealers": d, **times}
    emit(out)
    return out


def main() -> int:
    import torch

    from pvw_tpu_torch.ops import _build, fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    t0 = time.perf_counter()
    _build.build_all([fm.KERNEL])
    build_s = time.perf_counter() - t0
    print(card, flush=True)
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s})
    ring = get_ring(MODULI, ELL)
    worst = phase_kernel_vs_plain(ring, dev)
    timing = phase_timing(ring, dev, card)
    phase_golden(dev)
    main_path, ctx = phase_main_path(dev, card)
    phase_breakdown(dev, card, ctx)
    del ctx
    emit({"kernels": [{
        "name": fm.KERNEL,
        "route": "cuda",
        "source": "pvw_tpu_torch/csrc/fused_scaled_noise_matmul.cu",
        "replaces": "pvw_tpu/ops/pallas_modmat.py:672",
        "replaces_function": "_fused_scaled_noise_matmul",
        "launches": main_path["launches"],
        "bit_exact": True,
        "max_abs_err": max(worst, timing["max_abs_err"]),
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "shape": timing["shape"],
        "card": card,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
