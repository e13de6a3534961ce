#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card and hold its kernels
against their plain versions.

Run from the root of the repository, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

and, on a machine with four, the served mesh's phase alone (21c):

    python3 chip_smoke.py mesh_service

Phases, one JSON line each; any failure raises and exits non-zero. Every
dealer path is ``phase_dealer_path`` (CRS, batch keygen or an earlier path's keys,
the encryption operands, n dealers' shares in one batch, decryption with
every sampled share exact, decoded on the card by the device decode's
kernel, one launch a decryption (``device_decode.decode_residues.calls``
and ``.launches``;
a single message decrypts in the C++ host engine, ``engine_calls.host``),
and one party's shares decoded again by the Python decode and held
equal), with the kernels' launch counts set to 0 just
before it and read just after, per stage (keygen, encryption, the wrap
encryption): it fails if a kernel of its route did not launch, if a
kernel of another route did, if a band was relaid to k-packed on its
way into kernels 1 and 3 (``fused_modmat.band_relayouts``: kernel 4 writes
every band k-packed), or if an lhs operand was copied to 16-byte rows
(``fused_modmat.row_relayouts``: the key cache lays them out). The timing
phases' operands lie as the paths give them to the kernels (the band
k-packed); each kernel time is a median of
CUDA events with its spread [min, max], beside the bound, the plain twin,
``torch._int_mm`` of the same contraction, and the ratios to the bound and
to ``torch._int_mm``.

1. device: the card (``nvidia-smi`` name and power limit) and the build of
   the twelve kernel sources from ``pvw_tpu_torch/csrc`` (one nvcc each,
   started together, into ``build/kernels``), then of the C++ decode engine
   (``native/pvw_decode.cpp``, g++, into ``build/native``);
2. kernel_vs_plain: kernel 1, the fused scaled-noise matmul, against its
   plain PyTorch twin at the keygen, c1 and c2 shapes of the main path at
   a dealer batch of 512 (CH=16, kd=1280, nd=5), with jr=1/2 noise planes,
   value and digit noise rows, the 32-bit encode and the 64-bit encode
   with scalars around 2^63: bit-exact;
3. timing: kernel 1, its plain twin (one limb at a time) and
   ``torch._int_mm`` (the int8 contraction alone, a yardstick the port
   never calls) at the full c2 shape (m = n = 4096), CUDA events, median;
4. golden: the golden system of tests/test_golden.py on the card must give
   its five pinned hashes;
5. main_path: ``presets.pvss_8192(4096)`` (k = 256, l = 8, the 2-limb
   chain), default stream: 4096 dealers, four parties' shares decrypted,
   and one encryption with scalars >= 2^63 decoded with the reference's
   `as i64` semantics; then breakdown (each stage of one encryption and
   decryption timed alone; the decode on the card and by the Python decode
   on the same residues, per message, every message equal);
6. prescale_vs_plain: kernel 4, the fused r-stage (signed NTT +
   scaled-digit band), against its twin: the toy chain (nd = 5), the 4 x
   55-bit chain, the 17 x 61-bit chain at l = 16 with jr = 1 and 2, a
   61-bit chain at l = 64, a d off its column tile and quads, and the full
   config-4 r shape (k = 512, d = 1024): every band byte equal;
7. deep_kernel_vs_plain: kernel 1 at config 4's keygen, c1 and c2 shapes
   (CH = 272, nd = 8, kd = 4096) at a dealer batch of 256;
8. deep_timing: kernel 4 at the full config-4 and toy r shapes (its
   wrapper and its raw launch, interleaved) and kernel 1 at the full
   config-4 c2 shape, each beside its bound and twin;
9. deep_path: BASELINE config 4, ``presets.threshold_256bit(1024)`` (17 x
   61-bit limbs, k = 512, l = 16, nd = 8): 1024 dealers, threshold
   decryption of the 921 dealers whose index is not a multiple of 10 at
   threshold 683 for four parties, the abort one dealer below it, full
   decryption for two; then deep_breakdown;
9a. decode_vs_python: the device decode on the card (its kernel,
   ``csrc/pvw_decode.cu``) against the Python decode
   ``decode_scalar_pvw_rns`` and against its plain twin
   ``decode_residues_plain`` on the same card tensor, every message of a
   full batch (the CPU tests' edge rows, noisy encodings of random u64
   messages, uniform residues) at the toy chain (4096), config 4 (1024, a
   65-bit Δ) and the reference preset (1024); all three timed per message,
   the device decode also at a quarter of the batch, its aten op count and
   one decode under ``torch.profiler``; decode_timing: the kernel at both
   threshold cells' batches (921 messages of config 4 and of the
   reference), through its wrapper and raw, beside its bound and twin;
9b. contraction: decryption's contraction kernel (``csrc/noisy_messages.cu``:
   <s, c1> - c2 and the inverse NTT) against its plain twin
   ``noisy_messages_plain``, every residue, whole and partial, at both
   threshold cells' shapes (config 4: L = 17, l = 16, k = 512; the
   reference: L = 4, l = 8, k = 1024; 921 dealers), then timed through its
   wrapper and raw, beside its byte bound and twin; every dealer path gates
   one launch of it a device decryption;
10. v3k_vs_plain: the v3k noise generator against its twin, every byte, at
    the toy, config-4 and reference c1/c2 shapes (l = 8, 16, 32; jr = 1
    and 2; offsets; widths off its column tile); kernel 1 with ``gen_noise``
    and kernel 1 bare and encode-only (also at the full reference c2 shape);
11. v3k_timing: the generator at the full width of every product it serves,
    every byte against its twin, then timed beside its bound and twin, and
    without its wrapper (its C entry, 20 launches back to back between two
    events) beside the wrapper's host time a call;
11a. residue_noise_vs_plain: the residue-noise generator (bounds above the
    signed-digit range: stream-v2 draws, the centred embed and the forward
    NTT, channel-major for kernel 1's ``post=``) against its twin, every
    residue, at the reference's and config 4's c2 shapes, 128-bit draws
    with wrapping rows, a keygen chunk and l = 32; residue_noise_timing:
    at both c2 shapes through its wrapper and raw, beside its bound and
    twin; every dealer path gates its launches (one a product with residue
    noise, none elsewhere);
12. swapped_vs_plain: kernel 1's swapped form against its twin at reduced
    shapes (nd = 5 and 8, jr = 1 and 2, value and digit rows, bare, both
    encodes, m and n off its tile);
13. pipelined_vs_plain: the pipelined kernel 3 against its twin at reduced
    shapes (nd = 5 and 8, input planes and in-kernel v3k at jr = 1 and 2
    with offsets, value and digit rows, the encode alone, both encodes, m
    and n off its tile);
14. opt_in_timing: both at the full toy and config-4 c2 shapes, every
    output against the twin, then timed beside the bound, the twin,
    ``torch._int_mm`` and, for kernel 3, the generator + kernel 1 pair it
    replaces;
15. masked_vs_plain: kernel 1's masked form (6-word seeds: the generator's
    masked planes, the encode on the global rows [lo, hi) only) and its
    ``post=`` addmod against the twin at reduced shapes (nd = 5 and 8, jr =
    1 and 2, ranges empty, full, ragged and off the tile, with and without
    post=; post= alone and with the encode); banded_vs_plain: kernel 2,
    ``matmul_channels_fused``, at C = 9 and 15 with m and n off its tile;
16. banded_path: the entry ``matmul_fold_auto`` at kernel 2's two full
    shapes ([16 ch, 4096 x 256] x [256 x 1024], nd = 5; [272 ch, 1024 x 512]
    x [512 x 1024], nd = 8), counted (kernel 2 once, its operand layout
    kernel ``digit_planes`` twice), against the twin; banded_timing: the
    launch, the entry, the layout, the twin and ``torch._int_mm`` beside
    the bound; digits_timing: the layout kernel against its twin and its
    bytes' bound;
    masked_timing: the masked and post= launches at the toy and config-4 c2
    shapes;
16a. the probes' kernels (``pvw_tpu_torch/benchmarks``), each path at the
    toy and config-4 c2 shapes with its own launch gates (and none of them
    on any dealer path or backend): twopass_vs_plain (``fold_only`` against
    its plain version over the whole int32 range, reduced shapes),
    twopass_path (kernel 1 bare A; ``torch._int_mm`` into the int32 digit
    columns B; ``fold_only`` of them C; C == A and ``fold_only`` == its
    plain version, every residue) and twopass_timing (A, B, C, pass 2
    alone, bounds, the verdict); int32_peak (bit-exact on the JAX probe's
    (512, 1024) tile at 512 multiply-adds, then timed at 65536 and twice
    that: the linearity gate, IMAD/s, the JAX count and
    ``INT32_OPS_PER_S``); dot_structure_vs_plain and dot_structure_timing
    (kernel 1's contraction with a trivial epilogue in the planes, one_dot
    and wide band layouts against their plain versions, then timed beside
    the int8 bound, ``torch._int_mm`` and kernel 1 bare);
17. v3k_path: the toy chain under ``noise_stream="v3k"``, then
    v3k_breakdown; num_digits_path: the same chain and keys with
    ``settings.num_digits`` forced to 6, 7 and 8 on a freshly built ring:
    at each width kernel 4, the v3k generator and kernel 1 (``gen_noise``
    and the encode, bare and masked on a mesh shard's rows) against their
    twins at the path's shapes, kernel 1
    timed at the full c2 shape (nd = 5 too: num_digits_timing), and n
    dealers encrypted byte for byte as at nd = 5, party 0's shares exact;
18. v3k_deep_path: config 4 under v3k on the deep path's keys: threshold
    decryption for two parties, full for one;
19. swapped_path: config 4 under v3k on the same keys with
    ``settings.swapped_form``: the scaled key planes built (timed, and the
    peak device memory), threshold decryption for party 1023, full for
    party 0; then swapped_breakdown;
20. the multi-device backends on the same keys, cuda:0 repeated (a device
    may repeat in a mesh), each against the single-device ciphertext of the
    same key and scalars (``torch.equal``) with sampled shares exact and
    launch gates (a mesh's c1 on its recv row 0 only, c2 on every shard;
    the masked form for every v3k kdim > 1 or forced product and nowhere
    else, kernel 4 once a shard, no kernel 3 or swapped form, the bake
    route's products bare; each decryption equal to the single-device one
    by the Python decode, with a device decode a recv row of a mesh, one
    for gathered limbs or dealers): under v3k sharded_path ((2, 2) mesh),
    forced_masked_path ((1, 1), ``_force_masked``), data_parallel_path (4
    dealer shards), limb_parallel_path (17 limbs in 4 groups), grid_path
    (2 limb groups x a (1, 2) mesh); under the default stream
    sharded_bake_path ((2, 2));
21. reference_path: the reference's own 128-bit parameters,
    ``presets.secure_128_reference(1024)`` (k = 1024, l = 8, 4 x 55-bit
    limbs, variance 10, bounds (1, 1172385)) under v3k: all dealers
    decrypted for parties 0, 511 and 1023, then reference_breakdown;
21a. party_path (``phase_party_path``): the party's side at the same preset
    under v3k: batch keygen, then four parties re-make their keys one at a
    time with their errors recorded (each row exactly sᵀA + e), 1024 dealers
    encrypted after (the operand cache remade: the loaded global key
    encrypts the same bytes), every type to PVWT bytes, loaded on the card
    and to bytes again (identical; MB and ms a step), party 0 decrypting the
    loaded ciphertexts by each engine (16 dealers, a 32-dealer threshold
    subset and one message on the host engine, every dealer on the device
    decode and on the C++ decode, each gated by the engines' counters and
    equal to the Python decode), and a small ``pvw-vectors-v1`` case; then
    crossover: one party's decryption of d dealers on the device route and
    on the host route, d from 1 to 1024, interleaved, and the measured
    crossover (also on the toy chain after breakdown, d up to 4096);
21b. multiprocess_path (``parallel/multiprocess.py``): at the same
    preset, first the shards' kernels against their twins at the shapes
    the (2, 2) mesh gives them, there and at n = 8192, the
    ``ref128-n8192-mesh4`` cell's (multiprocess_vs_plain: kernel 4 at a
    shard's r; the generator's masked planes and kernel 1's masked form at
    recv row 0's c1 shards, each kdim block's rows and rows
    straddling both; kernel 1 bare at a bake-route c2 shard; the
    residue-noise generator at the bake route's block), then the
    in-process (2, 2) mesh on ``cuda:0`` repeated (``torch.equal`` to the
    single-device encryption, timed), then the mesh across processes: 4
    ranks x 1 device on the (2, 2) mesh over gloo (the ranks share the
    card), 1024 dealers under v3k, spawned as fresh interpreters; every rank
    prints ``MULTIPROC-OK`` (c1 and its c2 rows equal to its own
    single-device encryption, its dealers decoded exactly) and its launches
    and stage times; gates: kernel 4 and kernel 1 bare in every rank,
    kernel 1 masked and the generator on recv row 0, one device decode a
    recv row (its ops warmed on zero residues in set-up);
21c. mesh_service_path (``parallel/multiprocess.MeshService``), with four
    cards or more (else a skip line): the ``ref128-n8192-mesh4`` cell's
    configuration, ``secure_128_reference(8192)`` under v3k, 8192 dealers,
    served by 4 ranks a card each over NCCL, each rank holding its recv
    row's keys alone; one warm round, the launch counts set to 0 on every
    rank, one round; gates, per rank: kernel 4, kernel 1 bare and the
    residue-noise generator; kernel 1 masked and the v3k generator on recv
    row 0 alone; no other kernel;
22. pipelined_path: the toy chain at n = 4096 under v3k with
    ``settings.pipeline_fold`` (keygen and both products through kernel 3,
    no generator launch), full decryption for parties 0 and 4095; then
    pipelined_breakdown;
22a. examples: the four examples of ``pvw_tpu_torch.examples`` at their
    default sizes, each in its own interpreter, started together: rc 0,
    kernels 1 and 4 launched in each;
23. the kernels line (fifteen entries; kernel 1's with its time at each
    forced width), then the last line ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# the card's peaks that the bounds use (H100 SXM): HBM bandwidth, the dense
# int8 tensor-core rate and the INT32 issue rate; the dealer paths' c2
# shapes; the CUDA-event timings: a median ms, and a kernel's median of 5
# runs with its spread
from pvw_tpu_torch.benchmarks import (C2_SHAPES, HBM_BYTES_PER_S, INT8_OPS_PER_S,
                                      INT32_OPS_PER_S, cuda_ms, kernel_times)

# 32-bit operations of one v3k value: 1.5 Threefry-2x32-20 evaluations
# (20 rounds of add, rotate and xor, five key injections of two adds, two
# initial adds: 72) and the 96-bit reduction (three wide products, two
# carries, the offset: 8); counters and digit splits not counted
V3K_OPS_PER_VALUE = 1.5 * (20 * 3 + 5 * 2 + 2) + 8

# the toy chain: the moduli, ring degree, m receivers and k of its c2 product
MODULI, ELL, N_RECEIVERS, K_DIM, _ = C2_SHAPES["toy"]
COMPARE_BATCH = 512
GOLDEN_MODULI = (0xFFFFEE001, 0xFFFFC4001, 0x1FFFFE0001)
GOLDEN = {"crs": "87295f5306ea364d", "secret_key": "d3bc51f25628c4f5",
          "global_pk": "8d40adf52c1c9af2", "c1": "9c7654078768ba8f",
          "c2": "2d627fd108fc81bd"}
# BASELINE config 4: presets.threshold_256bit(1024), its chain named by
# its primes (bits, count)
DEEP_PRIMES, DEEP_ELL, DEEP_N, DEEP_K, _ = C2_SHAPES["config-4"]
DEEP_COMPARE_BATCH = 256
DEEP_THRESHOLD = 683                                  # ceil(2n/3)
# the reference's 128-bit example: presets.secure_128_reference(1024)
REF_N, REF_K = 1024, 1024
# kernel 2 at the JAX docstring's shape, [16 ch, 4096 x 256] x [256 x 1024]
# (pallas_modmat.py:1481-1483), and at config 4's [272 ch, 1024 x 512] x [512 x 1024]
BANDED_TOY = (4096, 256, 1024)
V3K_KEY = (0xDEADBEEF, 0x12345678)


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


def ratios(rec: dict) -> dict:
    """``rec`` with its time over the bound and over the library call."""
    rec["x_bound"] = rec["ms"] / rec["bound_ms"]
    rec["x_library"] = None if rec.get("library_ms") is None else rec["ms"] / rec["library_ms"]
    return rec


def timed(times: dict, name: str, fn):
    """``fn()``, its milliseconds on the host clock (every card synchronized
    before and after) stored in ``times[name]``."""
    import torch

    def sync():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    times[name] = (time.perf_counter() - t0) * 1e3
    return out


def max_abs_err(got, want) -> int:
    """max |got - want| of two integer tensors, one channel at a time."""
    import torch

    if torch.equal(got, want):
        return 0
    rows = got.shape[0] * got.shape[1]
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               for g, w in zip(got.reshape(rows, -1), want.reshape(rows, -1)))


# aten ops that make no new values (views) or only allocate: left out of
# op_count
_VIEW_OPS = frozenset({"alias", "as_strided", "detach", "empty", "empty_strided", "expand",
                       "lift_fresh", "narrow", "permute", "select", "slice", "split",
                       "squeeze", "t", "transpose", "unbind", "unsqueeze", "view",
                       "_reshape_alias", "_unsafe_view"})


def op_count(fn) -> int:
    """The aten ops that ``fn()`` dispatches, views and bare allocations
    left out: on a card, about its kernel launches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.__name__.split(".")[0] not in _VIEW_OPS:
                Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def profiled(fn) -> dict:
    """``fn()`` once under ``torch.profiler`` (CPU and CUDA): the wall ms
    (the profiler's own overhead included), the card's summed busy ms and
    event count (kernels, copies, fills), the idle share, and the ten
    entries with the most device time; None where it recorded no device
    time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the card's own events; the CPU ops that launched them report the same
    # time again, and the profiler's buffer request is not the program's work
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                 and e.self_device_time_total > 0 and not e.key.startswith("Activity Buffer")]
    device = sum(e.self_device_time_total for e in on_device) / 1e3
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    return {"wall_ms": wall, "device_ms": device or None,
            "device_events": sum(e.count for e in on_device) or None,
            "idle_share": 1 - device / wall if device else None,
            "top": [{"name": e.key[:90], "calls": e.count,
                     "device_ms": e.self_device_time_total / 1e3} for e in top]}


# kernel 1's launches with neither noise, encode nor post (the bake route's)
from pvw_tpu_torch.ops.fused_modmat import BARE_KERNEL as BARE  # noqa: E402
# the kernels of the measurement probes (pvw_tpu_torch/benchmarks/), which no
# dealer path launches; they count their launches on their own wrappers
from pvw_tpu_torch.benchmarks.fold_roofline import KERNEL as INT32_PEAK_KERNEL  # noqa: E402
from pvw_tpu_torch.benchmarks.probe_dot_structure import (  # noqa: E402
    KERNEL as DOT_KERNEL, LAYOUTS as DOT_LAYOUTS)
from pvw_tpu_torch.benchmarks.probe_twopass import KERNEL as FOLD_ONLY_KERNEL  # noqa: E402
# bands relaid to k-packed and lhs rows copied to a 16-byte pitch on their way
# into kernels 1 and 3: none on a path
RELAYOUTS = "band_relayouts"
ROW_RELAYOUTS = "row_relayouts"
# batches decoded on the residues' device (crypto/device_decode.py, its kernel
# csrc/pvw_decode.cu on a card: one launch a batch, counted in the registry)
from pvw_tpu_torch.crypto.device_decode import KERNEL as DECODE_KERNEL  # noqa: E402
DECODES = "decode_residues"
# the IMAD rate that fold_roofline measures on an H100 80GB HBM3 at 700 W:
# the device decode's bound (its work is 32 x 32 -> 64-bit multiply-adds)
IMAD_PER_S = 1.598e13
# the threshold cells' batch: one party's shares of 921 valid dealers
THRESHOLD_BATCH = 921
# batches of the other decode engines (crypto/decryption.engine_calls): the
# whole decryption in the C++ engine, the C++ decode of device residues, the
# Python decode
HOST_DECRYPTS = "host_decrypts"
NATIVE_DECODES = "native_decodes"
PYTHON_DECODES = "python_decodes"


def _counters() -> dict:
    """(wrapper, attribute) of each kernel's launch count (the kernels of
    ``ops/fused_modmat``, by its registry: kernel 1's masked and bare
    launches are also among its own; the probes' kernels, the
    dot-structure kernel per layout); the module's counts of band and row
    relayouts; and the batches of each decode engine."""
    from pvw_tpu_torch.benchmarks import fold_roofline, probe_dot_structure, probe_twopass
    from pvw_tpu_torch.crypto import decryption, device_decode
    from pvw_tpu_torch.ops import fused_modmat as fm

    ds = probe_dot_structure.dot_structure
    return {**fm.launch_counters(),
            FOLD_ONLY_KERNEL: (probe_twopass.fold_only, "launches"),
            INT32_PEAK_KERNEL: (fold_roofline.int32_peak, "launches"),
            **{dot_name(layout): (ds, f"{layout}_launches") for layout in DOT_LAYOUTS},
            RELAYOUTS: (fm, "band_relayouts"),
            ROW_RELAYOUTS: (fm, "row_relayouts"),
            DECODES: (device_decode.decode_residues, "calls"),
            HOST_DECRYPTS: (decryption.engine_calls, "host"),
            NATIVE_DECODES: (decryption.engine_calls, "native"),
            PYTHON_DECODES: (decryption.engine_calls, "python")}


def dot_name(layout: str) -> str:
    """The kernels line's and the counters' name of a dot-structure layout."""
    return f"{DOT_KERNEL}_{layout}"


def probe_kernels() -> list:
    """The counters' names of the probes' kernels, which no dealer path or
    backend launches."""
    return [FOLD_ONLY_KERNEL, INT32_PEAK_KERNEL, *map(dot_name, DOT_LAYOUTS)]


def reset_launches() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def launches() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def operands(ring, m, k, n, jr, encode, gen, dev):
    """Random operands of one fused-matmul call, made on the card: lhs
    digit planes, the scaled band (k-packed, as kernel 4 writes it), then
    :func:`noise_and_encode`."""
    import torch

    from pvw_tpu_torch.ops import modmat

    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    q = ring.table("q", dev).reshape(L, 1, 1, 1)
    a = torch.randint(0, 1 << 62, (L, S, m, k), generator=gen, device=dev) % q
    b = torch.randint(0, 1 << 62, (L, S, k, n), generator=gen, device=dev) % q
    lhs_dig = modmat.digits(a, nd).reshape(L, S, m, k * nd)
    band = modmat.prescale_digits_band(b, ring)
    return (lhs_dig, band, *noise_and_encode(ring, m, n, max(jr, 1), encode, gen, dev))


def noise_and_encode(ring, m, n, jr, encode, gen, dev):
    """(noise digit planes [l*jr, m, n] of values up to the bound, the
    bound (50 at jr = 1, else 2000), the encode operands or None): scalars
    below 2^32 for "enc32", and for "enc64" 64-bit ones with 0, 2^63,
    2^64 - 1 and 2^63 - 1 among them."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm, ntt, u64

    L, S = ring.num_limbs, ring.degree
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
    return noise, bound, enc


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


def phase_timing(ring, m: int, k: int, dev, card: str, phase: str) -> dict:
    """The fused matmul, its plain twin (one limb at a time) and
    torch._int_mm (the int8 contraction alone, a yardstick the port never
    calls) at a c2 shape of m receivers x m dealers, 32-bit encode: CUDA
    events, median of 3."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm

    gen = torch.Generator(device=dev).manual_seed(2)
    n = m
    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    lhs_dig, band, noise, bound, enc = operands(ring, m, k, n, 1, "enc32", gen, dev)
    kd = lhs_dig.shape[-1]

    def kernel():
        return fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc,
                                     lhs_dig=lhs_dig, encode32=True, noise_bound=bound)

    def plain():
        return fold_plain_by_limb(ring, band, lhs_dig, noise, enc)

    err = max_abs_err(kernel(), plain())
    check(err == 0, f"kernel differs from the plain twin at the full c2 shape ({phase})")
    torch.cuda.empty_cache()
    times = kernel_times(kernel)
    plain_ms = cuda_ms(plain, reps=3)
    torch.cuda.empty_cache()
    library_ms = cuda_ms(int_mm_banded(ring, lhs_dig, band), reps=3)
    macs = L * S * m * n * kd * nd
    nbytes = (lhs_dig.numel() + band.numel() + noise.numel() + 8 * m * n
              + 8 * L * S * m * n)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * macs / INT8_OPS_PER_S * 1e3
    out = ratios({"phase": phase, "kernel": fm.KERNEL,
                  "shape": f"c2 m={m} n={n} channels={L * S} kd={kd} nd={nd}",
                  "card": card, **times, "plain_ms": plain_ms,
                  "plain": "one limb at a time",
                  "library_ms": library_ms, "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                  "bytes": nbytes, "int8_macs": macs, "max_abs_err": err})
    emit(out)
    del lhs_dig, band, noise, enc
    torch.cuda.empty_cache()
    return out


def int_mm_banded(ring, lhs_dig, band):
    """One ``torch._int_mm`` a channel of the banded contraction (lhs
    [m, kd] against the band's nd planes side by side), a yardstick the port
    never calls: the rhs column-major ([nd*n, kd] rows, transposed), as
    cuBLASLt's int8 GEMM takes it."""
    import torch

    L, S, m, kd = lhs_dig.shape
    nd, n = band.shape[2], band.shape[4]
    a = lhs_dig.reshape(L * S, m, kd)
    bt = band.reshape(L * S, nd, kd, n).permute(0, 1, 3, 2).reshape(L * S, nd * n, kd).contiguous()

    def library():
        for c in range(L * S):
            torch._int_mm(a[c], bt[c].t())

    return library


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


def phase_breakdown(dev, card: str, ctx, name: str = "breakdown",
                    stream: str | None = "v4", route: str = "banded") -> dict:
    """The stages of one full-width encryption and decryption, each timed
    alone (host clock around work ending in a synchronize): where a path's
    time goes. The encryption is the entry point's own
    ``encryption._encrypt_kernel`` under ``stream`` (a value of
    ``settings.kernel_noise_stream()``) and ``route`` (the swapped form's
    scaled key planes, or ``settings.pipeline_fold`` on for "pipelined"),
    each stage timed through its ``stage`` hook. The decode runs twice on
    the same residues, on the card (``decode_device_ms``, the messages
    fetched) and by the Python decode (``decode_python_ms``, the residues
    fetched), every message held equal."""
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.crypto import decryption, encryption
    from pvw_tpu_torch.ops import u64

    params, gpk, shares = ctx["params"], ctx["gpk"], ctx["shares"]
    d = shares.shape[0]
    times = {}
    key = R.fold_in(R.key(0), 779)
    sc = timed(times, "scalars_to_device_ms", lambda: u64.u64_tensor(shares, dev))
    a_dig, b_dig = (gpk.encrypt_operands_swapped() if route == "swapped"
                    else gpk.encrypt_operands())
    settings.pipeline_fold = route == "pipelined"
    try:
        c1, c2 = encryption._encrypt_kernel(
            params, a_dig, b_dig, sc, key, int(shares.max()) < 1 << 32,
            *encryption._host_noise_pairs(params, key, d, dev), stream,
            stage=lambda stage, fn: timed(times, f"{stage}_ms", fn))
    finally:
        del settings.pipeline_fold
    sk = ctx["sk"].to_polynomials(dev).res
    z = timed(times, "decrypt_contract_ntt_ms", lambda: decryption._noisy_messages(
        params, sk, c1, c2[:, :, 0]))
    got = timed(times, "decode_device_ms", lambda: decryption._decode_batch(z, params))
    settings.decode_mode = "python"
    try:
        want = timed(times, "decode_python_ms", lambda: decryption._decode_batch(z, params))
    finally:
        del settings.decode_mode
    out = {"phase": name, "card": card, "stream": stream, "route": route, "dealers": d,
           **times, "decode_device_ms_per_message": times["decode_device_ms"] / d,
           "decode_python_ms_per_message": times["decode_python_ms"] / d,
           "decode_equal": got == want}
    emit(out)
    check(got == want, f"{name}: the device decode differs from the Python decode")
    return out


def edge_residues(params, d: int, seed: int) -> np.ndarray:
    """A full batch of PowerBasis residue blocks, uint64 [d, L, l]: the CPU
    tests' edge rows (coefficients that lift to q//2 and q//2 + 1; messages
    -1000, 1000, -1001, 1001, 2^64, 2^64 + 12345 and 2^65 + 1, each without
    and with noise; a zero row; multiples and halves of Δ and Δ^(l-1);
    2^64 - 1), then noisy encodings of random u64 messages in half the rest
    and uniform residues in the other half. A message v with noise e is the
    block of -(v Δ^j + e_j) mod q, what <s, c1> - c2 leaves; |e_j| <= Δ/4."""
    ring, l = params.ring, params.l
    q, delta, dpow = params.q_total(), params.delta(), params.delta_power_l_minus_1()
    rng = np.random.default_rng(seed)

    def noise():
        return rng.integers(-(delta // 4), delta // 4 + 1, size=l).tolist()

    def encoding(v, e):
        return [(-(v * delta ** j + e[j])) % q for j in range(l)]

    zero = [0] * l
    rows = [[q // 2] * l, [q // 2 + 1] * l, [q // 2 + j % 2 for j in range(l)],
            encoding(q // 2, zero), encoding(q // 2 + 1, zero), zero]
    for v in (-1000, 1000, -1001, 1001, 1 << 64, (1 << 64) + 12345, (1 << 65) + 1,
              (1 << 64) - 1):
        rows += [encoding(v % q, zero), encoding(v % q, noise())]
    for v in (delta, delta - 1, 2 * delta, q - delta, delta // 2, dpow % q, dpow // 2 % q,
              (dpow // 2 + 1) % q, (q - dpow) % q, (1 << 64) % q):
        rows.append([(v * (j + 1) + j) % q for j in range(l)])
    realistic = (d - len(rows)) // 2
    rows += [encoding(int(v), noise()) for v in rng.integers(0, 1 << 64, realistic,
                                                             dtype=np.uint64)]
    res = np.stack([rng.integers(0, m, size=(d, l), dtype=np.uint64) for m in ring.moduli], 1)
    for r, coeffs in enumerate(rows):
        res[r] = ring.residues_from_int_coeffs(coeffs)
    return res


def phase_decode_vs_python(dev, card: str, configs: dict) -> tuple[int, dict]:
    """The device decode (``decode_residues``: its kernel on the card)
    against the Python decode ``decode_scalar_pvw_rns`` and against its
    plain twin ``decode_residues_plain`` on the same card tensor, on every
    message of a full batch at each of ``configs`` (label -> (params, d)):
    :func:`edge_residues`. Then its host-clocked ms (median of 3, the
    decode and the fetch of the messages) beside the twin's and the Python
    decode's, per message, at d and d/4, its aten op count and one decode
    under ``torch.profiler`` (the card's busy ms and idle share); then
    :func:`decode_timing`. Any mismatch fails the run. Returns the kernel's
    mismatches with its twin (0) and the timings."""
    import torch

    from pvw_tpu_torch.crypto import decryption, device_decode
    from pvw_tpu_torch.ops import u64
    from pvw_tpu_torch.params import presets

    worst = 0
    for seed, (label, (params, d)) in enumerate(configs.items()):
        res = edge_residues(params, d, seed)
        z = u64.u64_tensor(res, dev)
        plan = device_decode.get_plan(params)

        def decode(rows=z):
            return u64.u64_numpy(device_decode.decode_residues(plan, rows))

        def plain(rows=z):
            return u64.u64_numpy(device_decode.decode_residues_plain(plan, rows))

        launched = device_decode.decode_residues.launches
        got = [int(v) for v in decode()]
        check(device_decode.decode_residues.launches == launched + 1,
              f"decode_vs_python: {label}'s decode did not launch its kernel once")
        twin = [int(v) for v in plain()]
        times = {}
        want = timed(times, "python_ms", lambda: [decryption.decode_scalar_pvw_rns(r, params)
                                                  for r in res])
        mismatches = [i for i in range(d) if got[i] != want[i]]
        twin_mismatches = [i for i in range(d) if got[i] != twin[i]]
        worst = max(worst, len(twin_mismatches))
        runs = {}
        for name, fn, rows in (("device_ms", decode, z), ("device_quarter_ms", decode,
                                                          z[:d // 4]),
                               ("plain_ms", plain, z)):
            runs[name] = []
            for _ in range(3):
                timed(times, name, lambda: fn(rows))
                runs[name].append(times[name])
        prof = profiled(decode)
        rec = {"phase": "decode_vs_python", "config": label, "card": card, "dealers": d,
               "limbs": params.ring.num_limbs, "l": params.l,
               "delta_bits": params.delta().bit_length(), "words": plan.W,
               "compared": "every message", "mismatches": len(mismatches),
               "first_mismatch": mismatches[0] if mismatches else None,
               "plain_twin_mismatches": len(twin_mismatches),
               "device_ms": statistics.median(runs["device_ms"]),
               "device_ms_runs": runs["device_ms"],
               "device_quarter_ms": statistics.median(runs["device_quarter_ms"]),
               "plain_ms": statistics.median(runs["plain_ms"]),
               "python_ms": times["python_ms"], "ops": op_count(decode),
               "profile": prof}
        rec["device_ms_per_message"] = rec["device_ms"] / d
        rec["plain_ms_per_message"] = rec["plain_ms"] / d
        rec["python_ms_per_message"] = rec["python_ms"] / d
        rec["quarter_over_full"] = rec["device_quarter_ms"] / rec["device_ms"]
        emit(rec)
        check(not mismatches, f"decode_vs_python: the device decode differs from the Python "
                              f"decode at {label}, message {rec['first_mismatch']}")
        check(not twin_mismatches, f"decode_vs_python: the decode kernel differs from its "
                                   f"plain twin at {label}, message {twin_mismatches[:1]}")
        del z
        torch.cuda.empty_cache()
    timing = decode_timing(dev, card, {
        "config 4": presets.threshold_256bit(DEEP_N),
        "reference": presets.secure_128_reference(REF_N)})
    return worst, timing


def decode_madds(plan, d: int) -> int:
    """32 x 32 -> 64-bit multiply-adds of the decode of d messages (each an
    IMAD; a native 64-bit Shoup product counts 10: the high word of a 64 x
    64 product 4, two low products 3 each; a 32-bit one 5): per message the
    l + 1 lifts (a Shoup product a limb, 2 L NWq column terms), the
    remainder mod Δ^(l-1) (fw nR terms of N R, nq nD of t D), the l - 1
    rounding divisions by 2Δ, the l - 1 words-to-RNS conversions (a 32-bit
    Shoup product a word and limb) and the 3l - 4 RNS steps of the chain
    (a Shoup product a limb)."""
    L, ell, _, nwq, m_fw, m_nr, m_nd, m_nq, v_fw, v_nr, v_nd, v_nq = plan.kernel_dims()
    per = ((ell + 1) * (10 * L + 2 * L * nwq) + m_fw * m_nr + m_nq * m_nd
           + (ell - 1) * (v_fw * v_nr + v_nq * v_nd) + 5 * L * (m_nd + (ell - 2) * v_nq)
           + 10 * L * (3 * ell - 4))
    return d * per


def decode_timing(dev, card: str, configs: dict) -> dict:
    """The decode kernel at each of ``configs`` (label -> params) on a
    threshold cell's batch (:data:`THRESHOLD_BATCH` messages of
    :func:`edge_residues`): through its wrapper (CUDA events, median of 5
    with the spread), and without it: its C entry and the wrapper, each 20
    launches back to back between two events, interleaved in 5 rounds (the
    raw launch's messages held equal to the wrapper's), the host time of a
    call of each; beside its plain twin (median of 3) and its bound, the
    multiply-adds of :func:`decode_madds` at :data:`IMAD_PER_S` or the
    residues read and the messages written once at ``HBM_BYTES_PER_S``,
    whichever is longer. No PyTorch call decodes: no library time."""
    import ctypes

    import torch

    from pvw_tpu_torch.crypto import device_decode
    from pvw_tpu_torch.ops import _build, u64
    from pvw_tpu_torch.ops._build import bind, ptr

    fn = bind(*device_decode.ENTRY)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    out = {}
    for seed, (label, params) in enumerate(configs.items()):
        d = THRESHOLD_BATCH
        plan = device_decode.get_plan(params)
        z = u64.u64_tensor(edge_residues(params, d, 40 + seed), dev)
        msgs = device_decode.decode_residues(plan, z)
        tab = plan.kernel_tables(dev)
        dims = (ctypes.c_int * 12)(*plan.kernel_dims())
        raw_out = torch.empty_like(msgs)
        raw_args = (ptr(z), d, dims, ptr(tab), tab.numel(), ptr(raw_out), stream)

        def raw():
            check(fn(*raw_args) == 0, "the decode kernel's raw launch failed")

        def wrapper():
            device_decode.decode_residues(plan, z)

        wrapped = kernel_times(wrapper)
        plain_ms = cuda_ms(lambda: device_decode.decode_residues_plain(plan, z), reps=3)
        back_to_back = interleaved_times({"wrapper": wrapper, "raw": raw}, rounds=5, inner=20)
        check(torch.equal(raw_out, msgs),
              f"the decode kernel's raw launch differs from its wrapper at {label}")
        check(torch.equal(msgs, device_decode.decode_residues_plain(plan, z)),
              f"the decode kernel differs from its plain twin at {label}'s timing batch")
        host_us = host_us_a_call({"wrapper": wrapper, "raw": raw})
        madds = decode_madds(plan, d)
        nbytes = 8 * d * (plan.L * plan.ell + 1)
        ops_ms, bytes_ms = madds / IMAD_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "decode_timing", "kernel": DECODE_KERNEL,
               "shape": f"{label} d={d} L={plan.L} l={plan.ell} W={plan.W}", "card": card,
               "compared": "every message", **wrapped, "plain_ms": plain_ms,
               "library_ms": None, "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "madds": madds, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
               "raw_ms": back_to_back["raw"]["ms"],
               "raw_ms_spread": back_to_back["raw"]["ms_spread"],
               "wrapper_back_to_back_ms": back_to_back["wrapper"]["ms"],
               "wrapper_back_to_back_ms_spread": back_to_back["wrapper"]["ms_spread"],
               "wrapper_host_us": host_us["wrapper"], "raw_host_us": host_us["raw"],
               "ptxas": _build.ptxas_report(DECODE_KERNEL)}
        rec["x_bound"] = rec["ms"] / rec["bound_ms"]
        rec["x_bound_raw"] = rec["raw_ms"] / rec["bound_ms"]
        out[label] = rec
        emit(rec)
        del z, msgs, raw_out
        torch.cuda.empty_cache()
    return out


def contraction_operands(ring, k: int, d: int, seed: int, dev) -> tuple:
    """Canonical residues made on the card: sk [k, L, l], c1 [L, l, k, d] and
    c2 [L, l, d] as ``.select`` hands them (contiguous), q - 1 in sk's first
    row and c1's first dealer (the largest products)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = ring.table("q", dev)

    def residues(shape):
        x = torch.randint(0, 1 << 62, shape, generator=g, device=dev, dtype=torch.int64)
        return x % q.reshape((1,) * (len(shape) - 1) + (-1,))

    L, l = ring.num_limbs, ring.degree
    sk = residues((k, l, L)).permute(0, 2, 1).contiguous()
    c1 = residues((l, k, d, L)).permute(3, 0, 1, 2).contiguous()
    c2 = residues((l, d, L)).permute(2, 0, 1).contiguous()
    sk[0] = (q - 1)[:, None]
    c1[..., 0] = (q - 1)[:, None, None]
    return sk, c1, c2


def phase_contraction(dev, card: str, configs: dict) -> tuple[int, dict]:
    """Decryption's contraction kernel (``fused_modmat.noisy_messages``,
    ``csrc/noisy_messages.cu``) at each of ``configs`` (label -> params) on a
    threshold cell's shape (:data:`THRESHOLD_BATCH` dealers, the preset's k,
    L and l): one launch, every residue against the plain twin
    ``noisy_messages_plain``, whole and partial (the mesh's form); then
    timed through its wrapper (CUDA events, median of 5 with the spread),
    and without it: its C entry and the wrapper, each 20 launches back to
    back between two events, interleaved in 5 rounds (the raw launch's
    residues held equal to the wrapper's), the host time of a call of each;
    beside its plain twin (median of 3) and its bound, c1, the key and c2
    read and the residues written once at ``HBM_BYTES_PER_S`` (its 64 x 64
    -> 128-bit products, counted as 8 multiply-adds each at
    :data:`IMAD_PER_S`, take less). No PyTorch call contracts: no library
    time. Returns the kernel's worst mismatch count with its twin (0) and
    the timings."""
    import ctypes

    import torch

    from pvw_tpu_torch.ops import _build, fused_modmat as fm
    from pvw_tpu_torch.ops._build import bind, ptr

    fn = bind(*fm.CONTRACTION_ENTRY)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    worst, out = 0, {}
    for seed, (label, params) in enumerate(configs.items()):
        ring, k, d = params.ring, params.k, THRESHOLD_BATCH
        L, l = ring.num_limbs, ring.degree
        sk, c1, c2 = contraction_operands(ring, k, d, 60 + seed, dev)
        launched = fm.noisy_messages.launches
        z = fm.noisy_messages(ring, sk, c1, c2)
        part = fm.noisy_messages(ring, sk, c1)
        check(fm.noisy_messages.launches == launched + 2,
              f"contraction: {label}'s two calls did not launch the kernel twice")
        want = fm.noisy_messages_plain(ring, sk, c1, c2)
        mismatches = int((z != want).sum()) + int((part != fm.noisy_messages_plain(
            ring, sk, c1)).sum())
        worst = max(worst, mismatches)
        raw_out = torch.empty_like(z)
        tab = fm.contraction_tables(ring, dev)
        raw_args = (L, l, k, d, ptr(sk), *sk.stride(), ptr(c1), *c1.stride()[:3], ptr(c2),
                    *c2.stride(), ptr(tab), ptr(raw_out), stream)

        def raw():
            check(fn(*raw_args) == 0, "the contraction kernel's raw launch failed")

        def wrapper():
            fm.noisy_messages(ring, sk, c1, c2)

        wrapped = kernel_times(wrapper)
        plain_ms = cuda_ms(lambda: fm.noisy_messages_plain(ring, sk, c1, c2), reps=3)
        back_to_back = interleaved_times({"wrapper": wrapper, "raw": raw}, rounds=5, inner=20)
        check(torch.equal(raw_out, z),
              f"the contraction kernel's raw launch differs from its wrapper at {label}")
        host_us = host_us_a_call({"wrapper": wrapper, "raw": raw})
        products = L * l * k * d
        nbytes = 8 * (L * l * k * d + k * L * l + 2 * L * l * d)
        ops_ms, bytes_ms = 8 * products / IMAD_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "contraction", "kernel": fm.CONTRACTION_KERNEL,
               "shape": f"{label} d={d} k={k} L={L} l={l}", "card": card,
               "compared": "every residue, whole and partial", "max_abs_err": mismatches,
               **wrapped, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "products": products, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
               "raw_ms": back_to_back["raw"]["ms"],
               "raw_ms_spread": back_to_back["raw"]["ms_spread"],
               "wrapper_back_to_back_ms": back_to_back["wrapper"]["ms"],
               "wrapper_back_to_back_ms_spread": back_to_back["wrapper"]["ms_spread"],
               "wrapper_host_us": host_us["wrapper"], "raw_host_us": host_us["raw"],
               "ptxas": _build.ptxas_report(fm.CONTRACTION_KERNEL)}
        rec["x_bound"] = rec["ms"] / rec["bound_ms"]
        rec["x_bound_raw"] = rec["raw_ms"] / rec["bound_ms"]
        rec["x_plain_raw"] = plain_ms / rec["raw_ms"]
        out[label] = rec
        emit(rec)
        check(not mismatches, f"contraction: the kernel differs from its plain twin in "
                              f"{mismatches} residues at {label}")
        del sk, c1, c2, z, part, want, raw_out
        torch.cuda.empty_cache()
    return worst, out

# --------------------------------------------------------------------------
# the deep chain: BASELINE config 4 (17 x 61-bit limbs, l = 16, nd = 8)
# --------------------------------------------------------------------------

def prescale_bound(ring, k: int, d: int, jr: int) -> dict:
    """The least time of one r-stage call: the band written and the
    coefficients read once, against its operations: the NTT's int8 digit
    MACs at the int8 rate or the fold and scale Shoup products (three
    64-bit products each, four 32-bit multiply-adds a product, one INT32
    lane-operation each) on the CUDA cores, whichever takes longer (the two
    units run side by side)."""
    L, l, nd = ring.num_limbs, ring.degree, ring.num_digits
    C1 = nd + jr - 1
    groups = L * l * k * d
    nbytes = groups * nd * nd + k * d * l * 4
    int8_macs = groups * C1 * l * jr
    core_madds = groups * ((C1 + 3) // 4 + nd - 1) * 3 * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(2 * int8_macs / INT8_OPS_PER_S, core_madds / INT32_OPS_PER_S) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "int8_macs": int8_macs, "core_madds": core_madds}


def r_coeffs(k: int, d: int, l: int, bound: int, gen, dev):
    import torch

    c = torch.randint(-bound, bound + 1, (k, d, l), generator=gen, device=dev,
                      dtype=torch.int32)
    c[0, 0], c[0, 1] = bound, -bound                  # both ends of the range
    return c


def phase_prescale_vs_plain(dev) -> int:
    """The r-stage kernel against its plain twin, every band byte."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params import presets
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    gen = torch.Generator(device=dev).manual_seed(3)
    deep = generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL)
    cases = [("toy chain", MODULI, ELL, 1, K_DIM, COMPARE_BATCH),
             ("4 x 55-bit chain, d off the 256-column tile", presets.MODULI_55BIT4, ELL, 1,
              K_DIM, 1000),
             ("17 x 61-bit chain, jr = 2, d off the 4-column quads", deep, DEEP_ELL, 200,
              DEEP_K, 130),
             ("17 x 61-bit chain, jr = 2", deep, DEEP_ELL, 32639, 64, DEEP_N),
             ("2 x 61-bit chain at l = 64, jr = 2", generate_ntt_primes(61, 2, 64), 64,
              2000, 16, 130),
             ("config-4 r, full shape", deep, DEEP_ELL, 1, DEEP_K, DEEP_N)]
    worst = 0
    for name, moduli, l, bound, k, d in cases:
        ring = get_ring(tuple(moduli), l)
        c = r_coeffs(k, d, l, bound, gen, dev)
        got = fm.ntt_prescale_band(c, ring, bound)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = fm.ntt_prescale_band_plain(c, ring, bound)
        torch.cuda.synchronize()
        plain_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        err = max_abs_err(got, want)
        worst = max(worst, err)
        emit({"phase": "prescale_vs_plain", "shape": name, "limbs": ring.num_limbs, "l": l,
              "nd": ring.num_digits, "jr": 1 if bound <= 127 else 2, "k": k, "d": d,
              "band_gb": got.numel() / 1e9, "plain_peak_gb": plain_peak,
              "compared": "whole band", "bit_exact": err == 0, "max_abs_err": err})
        check(err == 0, f"the r-stage kernel differs from its twin at {name}")
        del c, got, want
        torch.cuda.empty_cache()
    return worst


def plain_by_limb(ring, twin, lhs, rhs, noise=None, encode=None, **per_limb):
    """A fused matmul's plain twin ``twin(lhs, rhs, ring, noise, encode,
    **per_limb)``, one limb at a time (its float64 operands at config 4
    would not fit whole; every limb of the chains here has the chain's
    digit count); ``per_limb`` tensors are cut by limb too."""
    import torch

    from pvw_tpu_torch.params.ring import get_ring

    S, outs = ring.degree, []
    for i, q in enumerate(ring.moduli):
        sub = get_ring((q,), S)
        check(sub.num_digits == ring.num_digits, "a limb's digit width differs")
        enc = None if encode is None else (encode[0], encode[1][i * S:(i + 1) * S])
        kws = {name: None if t is None else t[i:i + 1] for name, t in per_limb.items()}
        outs.append(twin(lhs[i:i + 1], rhs[i:i + 1], sub, noise, enc, **kws))
    return torch.cat(outs)


def fold_plain_by_limb(ring, band, lhs_dig, noise=None, encode=None, post=None, mask=None):
    """:func:`plain_by_limb` of kernel 1's twin (and the pipelined kernel's;
    ``post`` and the masked form's ``mask`` = (row_off, lo, hi) too)."""
    from pvw_tpu_torch.ops import fused_modmat as fm

    return plain_by_limb(ring, lambda lhs, rhs, sub, nz, enc, post=None: (
        fm.matmul_fold_scaled_plain(None, rhs, sub, noise=nz, encode=enc, lhs_dig=lhs,
                                    post=post, mask=mask)),
        lhs_dig, band, noise, encode, post=post)


def swapped_plain_by_limb(ring, planes, rhs_dig, noise=None, encode=None):
    """:func:`plain_by_limb` of the swapped form's twin."""
    from pvw_tpu_torch.ops import fused_modmat as fm

    return plain_by_limb(ring, fm.matmul_fold_swapped_plain, planes, rhs_dig, noise, encode)


def phase_deep_kernel_vs_plain(dev) -> int:
    import torch

    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    ring = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    gen = torch.Generator(device=dev).manual_seed(4)
    d = DEEP_COMPARE_BATCH
    cases = [("keygen", d, DEEP_K, 1, None, True),
             ("keygen", d, DEEP_K, 2, None, False),
             ("c1", DEEP_K, d, 1, None, True),
             ("c1", DEEP_K, d, 2, None, False),
             ("c2", DEEP_N, d, 1, "enc32", True),
             ("c2", DEEP_N, d, 2, "enc64", True),
             ("c2", DEEP_N, d, 1, "enc64", False)]
    worst = 0
    for name, m, n, jr, encode, vals in cases:
        lhs_dig, band, noise, bound, enc = operands(ring, m, DEEP_K, n, jr, encode, gen, dev)
        settings.noise_value_mac = vals
        try:
            got = fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc,
                                        lhs_dig=lhs_dig, encode32=encode == "enc32",
                                        noise_bound=bound)
        finally:
            del settings.noise_value_mac
        want = fold_plain_by_limb(ring, band, lhs_dig, noise, enc)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        emit({"phase": "deep_kernel_vs_plain", "shape": name, "m": m, "n": n,
              "kd": lhs_dig.shape[-1], "channels": ring.num_limbs * ring.degree,
              "nd": ring.num_digits, "jr": jr, "noise_rows": "values" if vals else "digits",
              "encode": encode or "none", "bit_exact": err == 0, "max_abs_err": err})
        check(err == 0, f"the fused matmul differs from its twin at config-4 {name}")
        del lhs_dig, band, noise, enc, got, want
        torch.cuda.empty_cache()
    return worst


def interleaved_times(calls: dict, rounds: int, inner: int = 10) -> dict:
    """name -> the median ms of one call of ``calls[name]`` and its spread:
    each round times ``inner`` calls of every entry in turn between two
    CUDA events, so that they share the card's state."""
    import torch

    for fn in calls.values():
        fn()
    times = {name: [] for name in calls}
    for _ in range(rounds):
        for name, fn in calls.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / inner)
    return {name: {"ms": statistics.median(t), "ms_spread": [min(t), max(t)]}
            for name, t in times.items()}


def host_us_a_call(calls: dict) -> dict:
    """name -> the host microseconds of one call of ``calls[name]``: 20
    calls with no synchronize between, the card idle before them."""
    import torch

    out = {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        out[name] = (time.perf_counter() - t0) / 20 * 1e6
        torch.cuda.synchronize()
    return out


def prescale_timing(ring, k: int, d: int, seed: int, dev, card: str) -> dict:
    """The r-stage kernel and its plain twin at one r shape (jr = 1), each
    against the bound: the wrapper as a path calls it and the raw launch
    (its C entry on prepared arguments), interleaved in 10 rounds of 10
    calls (medians with the spread), and the twin, a median of 3; CUDA
    events."""
    import ctypes

    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.ops._build import bind, ptr

    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = r_coeffs(k, d, S, 1, gen, dev)
    ntab, tabs = fm._prescale_tables(ring, 1, dev)
    out = torch.empty((L, S, nd, d, -(-k * nd // 16) * 16), dtype=torch.int8, device=dev)
    fn = bind(*fm.PRESCALE_ENTRY)
    args = (ptr(c), ptr(ntab), ptr(tabs), ptr(out), L, S, 1, k, d, nd,
            out.shape[-1], ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))

    def raw():
        check(fn(*args) == 0, "kernel 4's raw launch failed")

    t = interleaved_times({"wrapper": lambda: fm.ntt_prescale_band(c, ring, 1), "raw": raw},
                          rounds=10)
    check(torch.equal(out[..., :k * nd].transpose(-1, -2), fm.ntt_prescale_band(c, ring, 1)),
          "kernel 4's raw launch differs from its wrapper")
    plain_ms = cuda_ms(lambda: fm.ntt_prescale_band_plain(c, ring, 1), reps=3)
    res = ratios({"phase": "deep_timing", "kernel": fm.PRESCALE_KERNEL,
                  "shape": f"r k={k} d={d} channels={L * S} nd={nd} jr=1",
                  "card": card, **t["wrapper"], "raw_ms": t["raw"]["ms"],
                  "raw_ms_spread": t["raw"]["ms_spread"], "plain_ms": plain_ms,
                  "library_ms": None, **prescale_bound(ring, k, d, 1)})
    res["x_bound_raw"] = res["raw_ms"] / res["bound_ms"]
    emit(res)
    del c, out
    torch.cuda.empty_cache()
    return res


def phase_deep_timing(dev, card: str) -> dict:
    """The r-stage kernel at the full config-4 r shape and the fused matmul
    at the full config-4 c2 shape, each against its bound and twin; the
    r-stage kernel also at the toy chain's r shape."""
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    ring = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    return {"prescale": prescale_timing(ring, DEEP_K, DEEP_N, 5, dev, card),
            "prescale_toy": prescale_timing(get_ring(MODULI, ELL), K_DIM, N_RECEIVERS, 6,
                                            dev, card),
            "matmul": phase_timing(ring, DEEP_N, DEEP_K, dev, card, "deep_timing")}


# --------------------------------------------------------------------------
# stream v3k: the noise generator, and the reference's 128-bit parameters
# --------------------------------------------------------------------------

def phase_v3k_vs_plain(dev) -> int:
    """The v3k generator against its plain twin, every byte; the fused
    matmul with ``gen_noise`` against the plain fold of the same planes;
    the fused matmul bare and encode-only against its plain twin."""
    import torch

    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm, tfry
    from pvw_tpu_torch.params import presets
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    d, dd = COMPARE_BATCH, DEEP_COMPARE_BATCH
    worst = 0

    def compare(what: dict, got, want) -> None:
        nonlocal worst
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        emit({"phase": "v3k_vs_plain", **what, "bit_exact": err == 0, "max_abs_err": err})
        check(err == 0, f"{what['kernel']} differs from its plain twin at {what['shape']}")

    # the generator: name, rows, cols, l, bound, row offset, column offset
    for name, rows, cols, l, bound, row_off, col_off in (
            ("toy c1", K_DIM, d, ELL, 50, 0, 0),
            ("toy c2", N_RECEIVERS, d, ELL, 2000, 0, 0),
            ("config-4 c1", DEEP_K, dd, DEEP_ELL, 2000, 0, 0),
            ("config-4 c2", DEEP_N, dd, DEEP_ELL, 50, 0, 0),
            ("reference c1", REF_K, dd, 8, 1, 0, 0),
            ("l = 32, offsets, cols off the 128-column tile", 64, 300, 32, 2000, 77, 1 << 20),
            ("l = 16, offsets, cols off the tile", 100, 129, DEEP_ELL, 127, 3, 5)):
        compare({"kernel": fm.NOISE_KERNEL, "shape": name, "rows": rows, "cols": cols,
                 "l": l, "bound": bound, "jr": 1 if bound <= 127 else 2,
                 "row_off": row_off, "col_off": col_off, "compared": "every byte"},
                fm.v3k_noise_planes(*V3K_KEY, row_off, rows, cols, l, bound, col_off, dev),
                tfry.v3k_noise_digit_planes(*V3K_KEY, row_off, rows, cols, l, bound,
                                            col_off, dev))

    toy = get_ring(MODULI, ELL)
    deep = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    ref = get_ring(presets.MODULI_55BIT4, 8)
    gen = torch.Generator(device=dev).manual_seed(7)
    # gen_noise: name, ring, m, k, n, jr, value rows, row offset, column offset
    for name, ring, m, k, n, jr, vals, row_off, col_off in (
            ("toy c2", toy, N_RECEIVERS, K_DIM, d, 1, True, 0, 3),
            ("toy c2", toy, N_RECEIVERS, K_DIM, d, 2, False, 0, 0),
            ("config-4 c1", deep, DEEP_K, DEEP_K, dd, 1, True, 0, 0),
            ("config-4 c2", deep, DEEP_N, DEEP_K, dd, 2, False, 5, 0)):
        lhs_dig, band, _, bound, _ = operands(ring, m, k, n, jr, None, gen, dev)
        settings.noise_value_mac = vals
        try:
            got = fm.matmul_fold_scaled(None, band, ring, lhs_dig=lhs_dig, gen_noise=(
                (*V3K_KEY, row_off, col_off), jr, bound, "tfry"))
        finally:
            del settings.noise_value_mac
        planes = tfry.v3k_noise_digit_planes(*V3K_KEY, row_off, m, n, ring.degree, bound,
                                             col_off, dev)
        compare({"kernel": f"{fm.NOISE_KERNEL} + {fm.KERNEL}", "shape": f"gen_noise {name}",
                 "m": m, "n": n, "kd": lhs_dig.shape[-1], "jr": jr,
                 "noise_rows": "values" if vals else "digits"},
                got, fold_plain_by_limb(ring, band, lhs_dig, planes))
        del lhs_dig, band, got, planes
    # no noise rows: name, ring, m, k, n, encode
    for name, ring, m, k, n, encode in (
            ("toy c2", toy, N_RECEIVERS, K_DIM, d, None),
            ("toy c2", toy, N_RECEIVERS, K_DIM, d, "enc64"),
            ("reference c1", ref, REF_K, REF_K, dd, None),
            ("reference c2", ref, REF_N, REF_K, dd, "enc32"),
            ("reference c2, full width", ref, REF_N, REF_K, REF_N, "enc32")):
        lhs_dig, band, _, _, enc = operands(ring, m, k, n, 1, encode, gen, dev)
        got = fm.matmul_fold_scaled(None, band, ring, encode=enc, lhs_dig=lhs_dig,
                                    encode32=encode == "enc32")
        compare({"kernel": fm.KERNEL, "shape": f"{'encode-only' if encode else 'bare'} {name}",
                 "m": m, "n": n, "kd": lhs_dig.shape[-1], "channels": ring.num_limbs * 8,
                 "encode": encode or "none"},
                got, fold_plain_by_limb(ring, band, lhs_dig, None, enc))
        del lhs_dig, band, enc, got
    torch.cuda.empty_cache()
    return worst


def phase_v3k_timing(dev, card: str) -> dict:
    """The generator at the full width of every product it serves on the
    v3k paths, with their bounds, and at the toy c2 shape with jr = 2:
    every byte against its plain twin, then both timed (CUDA events, median
    of 3) beside the bound (its 32-bit integer operations, or the planes
    written once, whichever is longer). Then the kernel without its
    wrapper: its C entry on prepared arguments and the wrapper as a path
    calls it, each 20 launches back to back between two events, interleaved
    in 5 rounds (medians with the spread; the raw launch's planes held
    equal to the wrapper's), and the host time of one call of each (20
    calls, no synchronize between). No PyTorch call computes Threefry-2x32:
    no library time."""
    import ctypes

    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm, tfry
    from pvw_tpu_torch.ops._build import bind, ptr

    fn = bind(*fm.NOISE_ENTRY)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    out = {}
    for name, rows, cols, l, bound in (
            ("toy c1", K_DIM, N_RECEIVERS, ELL, 50),
            ("toy c2", N_RECEIVERS, N_RECEIVERS, ELL, 50),
            ("toy c2, jr = 2", N_RECEIVERS, N_RECEIVERS, ELL, 2000),
            ("config-4 c1", DEEP_K, DEEP_N, DEEP_ELL, 50),
            ("config-4 c2", DEEP_N, DEEP_N, DEEP_ELL, 50),
            ("reference c1", REF_K, REF_N, 8, 1)):
        args = (*V3K_KEY, 0, rows, cols, l, bound, 0, dev)
        err = max_abs_err(fm.v3k_noise_planes(*args), tfry.v3k_noise_digit_planes(*args))
        check(err == 0, f"the v3k generator differs from its plain twin at full-width {name}")
        torch.cuda.empty_cache()
        ms = cuda_ms(lambda: fm.v3k_noise_planes(*args), reps=3)
        plain_ms = cuda_ms(lambda: tfry.v3k_noise_digit_planes(*args), reps=3)
        jr = 1 if bound <= 127 else 2
        planes = torch.empty((l * jr, rows, cols), dtype=torch.int8, device=dev)
        raw_args = (V3K_KEY[0], V3K_KEY[1], 0, 0, rows, cols, l, jr, bound, 0, 0, 0,
                    ptr(planes), stream)

        def raw():
            check(fn(*raw_args) == 0, "the v3k generator's raw launch failed")

        def wrapper():
            fm.v3k_noise_planes(*args)

        back_to_back = interleaved_times({"wrapper": wrapper, "raw": raw}, rounds=5, inner=20)
        check(torch.equal(planes, fm.v3k_noise_planes(*args)),
              f"the v3k generator's raw launch differs from its wrapper at {name}")
        host_us = host_us_a_call({"wrapper": wrapper, "raw": raw})
        del planes
        values = rows * cols * l
        ops = values * V3K_OPS_PER_VALUE
        ops_ms = ops / INT32_OPS_PER_S * 1e3
        bytes_ms = values * jr / HBM_BYTES_PER_S * 1e3
        out[name] = {"phase": "v3k_timing", "kernel": fm.NOISE_KERNEL,
                     "shape": f"{name} rows={rows} cols={cols} l={l} jr={jr}",
                     "bound": bound, "card": card, "compared": "every byte",
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": max(ops_ms, bytes_ms),
                     "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                     "values": values, "int32_ops": ops, "bytes": values * jr,
                     "ops_ms": ops_ms, "bytes_ms": bytes_ms,
                     "raw_ms": back_to_back["raw"]["ms"],
                     "raw_ms_spread": back_to_back["raw"]["ms_spread"],
                     "wrapper_back_to_back_ms": back_to_back["wrapper"]["ms"],
                     "wrapper_back_to_back_ms_spread": back_to_back["wrapper"]["ms_spread"],
                     "wrapper_host_us": host_us["wrapper"], "raw_host_us": host_us["raw"]}
        out[name]["x_bound"] = ms / out[name]["bound_ms"]
        out[name]["x_bound_raw"] = out[name]["raw_ms"] / out[name]["bound_ms"]
        emit(out[name])
        torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the residue-noise generator: bounds above the signed-digit range
# --------------------------------------------------------------------------

def residue_ops(rows: int, cols: int, l: int, limbs: int, words: int) -> float:
    """32-bit operations of the residue-noise generator: per (row, column)
    the row key and ``words`` * l draw words (Threefry-2x32-20, 72 each as
    in V3K_OPS_PER_VALUE, and a xor each), each value's reduction (8 at
    three words, 16 at four) and centring (2); per limb, each value's
    residue (3) and the l x l dense NTT, a term a native 64-bit Shoup
    product (the high word of a 64 x 64 product: 4 wide multiply-adds and
    2 carries; two low products, 3 each; the subtraction and the
    conditional one, 4) and an addmod (4): 20."""
    per = ((words * l + 1) * 72 + words * l + l * ((8 if words == 3 else 16) + 2)
           + limbs * (3 * l + 20 * l * l))
    return rows * cols * per


def phase_residue_noise(dev, card: str) -> tuple[int, dict]:
    """The residue-noise generator (``fused_modmat.residue_noise_ch``)
    against its plain twin, every residue: the reference's c2 at full width
    (96-bit draws), config 4's c2 shape with the same bound, 128-bit draws
    with a row offset that wraps, a keygen chunk's (parties, k) call and a
    shard's rows at l = 32; then, at the reference's c2 shape and config 4's,
    timed through its wrapper (CUDA events, median of 5 with the spread)
    beside its twin and its bound (the 32-bit operations of
    :func:`residue_ops` at ``INT32_OPS_PER_S`` or the residues written once
    at ``HBM_BYTES_PER_S``, whichever is longer), and without its wrapper:
    its C entry and the wrapper, each 20 launches back to back between two
    events, interleaved in 5 rounds (the raw launch's residues held equal
    to the wrapper's), and the host time of one call of each. No PyTorch
    call computes Threefry-2x32: no library time."""
    import ctypes

    import torch

    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.ops._build import bind, ptr
    from pvw_tpu_torch.params import presets
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    ref = get_ring(presets.MODULI_55BIT4, 8)
    deep = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    toy = get_ring(MODULI, ELL)
    wide = get_ring(generate_ntt_primes(61, 2, 64), 32)
    kk = R.fold_in(R.key(14), 2)
    c2_bound = presets.secure_128_reference(8).error_bound_2
    worst = 0
    for name, ring, rows, cols, bound, row_off in (
            ("reference c2", ref, REF_N, REF_N, c2_bound, 0),
            ("config-4 c2", deep, DEEP_N, DEEP_N, c2_bound, 0),
            ("128-bit draws, wrapping rows", toy, 1000, 300, (1 << 31) + 5, (1 << 32) - 5),
            ("keygen chunk (parties x k)", ref, 256, REF_K, c2_bound, 512),
            ("a shard's rows at l = 32", wide, 130, 257, 50000, 77)):
        want = fm.residue_noise_ch_plain(kk, row_off, rows, cols, bound, ring, dev)
        got = fm.residue_noise_ch(kk, row_off, rows, cols, bound, ring, dev)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        worst = max(worst, err)
        emit({"phase": "residue_noise_vs_plain", "kernel": fm.RESIDUE_NOISE_KERNEL,
              "shape": name, "rows": rows, "cols": cols, "l": ring.degree,
              "limbs": ring.num_limbs, "bound": bound, "row_off": row_off,
              "words": 3 if 2 * bound + 1 < 1 << 30 else 4, "compared": "every residue",
              "bit_exact": err == 0, "max_abs_err": err})
        check(err == 0, f"the residue-noise generator differs from its twin at {name}")
        del want, got
        torch.cuda.empty_cache()

    fn = bind(*fm.RESIDUE_NOISE_ENTRY)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    k0, k1 = (int(w) for w in kk)
    out = {}
    for name, ring, rows, cols in (("reference c2", ref, REF_N, REF_N),
                                   ("config-4 c2", deep, DEEP_N, DEEP_N)):
        args = (kk, 0, rows, cols, c2_bound, ring, dev)
        res = fm.residue_noise_ch(*args)
        raw_args = (k0, k1, 0, rows, cols, ring.degree, ring.num_limbs, c2_bound,
                    ptr(ring.table("q", dev)), ptr(fm._residue_noise_tables(ring, dev)),
                    ptr(res), stream)

        def raw():
            check(fn(*raw_args) == 0, "the residue-noise generator's raw launch failed")

        def wrapper():
            fm.residue_noise_ch(*args)

        wrapped = kernel_times(wrapper)
        plain_ms = cuda_ms(lambda: fm.residue_noise_ch_plain(*args), reps=3)
        back_to_back = interleaved_times({"wrapper": wrapper, "raw": raw}, rounds=5, inner=20)
        check(torch.equal(res, fm.residue_noise_ch(*args)),
              f"the residue-noise generator's raw launch differs from its wrapper at {name}")
        host_us = host_us_a_call({"wrapper": wrapper, "raw": raw})
        del res
        ops = residue_ops(rows, cols, ring.degree, ring.num_limbs, 3)
        nbytes = 8 * ring.num_limbs * ring.degree * rows * cols
        ops_ms, bytes_ms = ops / INT32_OPS_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        rec = {"phase": "residue_noise_timing", "kernel": fm.RESIDUE_NOISE_KERNEL,
               "shape": f"{name} rows={rows} cols={cols} l={ring.degree} "
                        f"L={ring.num_limbs} W=3",
               "bound": c2_bound, "card": card, "compared": "every residue",
               **wrapped, "plain_ms": plain_ms, "library_ms": None,
               "bound_ms": max(ops_ms, bytes_ms),
               "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
               "int32_ops": ops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
               "raw_ms": back_to_back["raw"]["ms"],
               "raw_ms_spread": back_to_back["raw"]["ms_spread"],
               "wrapper_back_to_back_ms": back_to_back["wrapper"]["ms"],
               "wrapper_back_to_back_ms_spread": back_to_back["wrapper"]["ms_spread"],
               "wrapper_host_us": host_us["wrapper"], "raw_host_us": host_us["raw"]}
        rec["x_bound"] = rec["ms"] / rec["bound_ms"]
        rec["x_bound_raw"] = rec["raw_ms"] / rec["bound_ms"]
        out[name] = rec
        emit(rec)
        torch.cuda.empty_cache()
    return worst, out


# --------------------------------------------------------------------------
# the opt-in forms: kernel 1's swapped variant and the pipelined kernel
# --------------------------------------------------------------------------

def swapped_operands(ring, m, k, n, jr, encode, gen, dev, digits_only: bool = False):
    """Operands of one swapped-form call on the card: the scaled planes
    [L, S, nd, m, k*nd] and plain digits [L, S, k*nd, n] (k-packed, as
    ``rhs_digit_cols`` lays them out) of random residues
    (or, with ``digits_only``, random int8 digits: any digits are inputs of
    the same function, and they are made at full width in a moment), then
    :func:`noise_and_encode`; no noise at jr = 0."""
    import torch

    from pvw_tpu_torch.ops import modmat

    L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
    if digits_only:
        planes = torch.randint(-128, 128, (L, S, nd, m, k * nd), generator=gen, device=dev,
                               dtype=torch.int8)
        rd = torch.randint(-128, 128, (L, S, n, k * nd), generator=gen, device=dev,
                           dtype=torch.int8).transpose(-1, -2)      # k-packed, as made
    else:
        q = ring.table("q", dev)
        a = torch.randint(0, 1 << 62, (m, k, L, S), generator=gen, device=dev) \
            % q.reshape(1, 1, L, 1)
        r = torch.randint(0, 1 << 62, (L, S, k, n), generator=gen, device=dev) \
            % q.reshape(L, 1, 1, 1)
        planes, rd = modmat.lhs_scaled_planes(a, ring), modmat.rhs_digit_cols(r, ring)
    noise, bound, enc = noise_and_encode(ring, m, n, max(jr, 1), encode, gen, dev)
    return planes, rd, noise if jr else None, bound if jr else None, enc


def compared(phase: str, what: dict, kernel: str, got_fn, want):
    """Run ``got_fn`` (one launch of ``kernel``, counted), hold it against
    ``want`` and emit the line; returns max |got - want|."""
    import torch

    before = launches()[kernel]
    got = got_fn()
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    ran = launches()[kernel] - before
    emit({"phase": phase, **what, "launches": ran, "bit_exact": err == 0,
          "max_abs_err": err})
    check(ran == 1, f"{what['shape']}: the kernel did not launch once")
    check(err == 0, f"{phase}: the kernel differs from its plain twin at {what['shape']}")
    return err


def phase_swapped_vs_plain(dev) -> int:
    """Kernel 1's swapped form against its twin at reduced shapes: nd = 5
    (toy chain) and nd = 8 (config 4's chain, CH = 272), noise jr = 1 and 2
    as value and digit rows, bare, both encodes, m and n off its 32 x 128
    tile; the operands are the scaled planes and plain digits of random
    residues."""
    import torch

    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    toy = get_ring(MODULI, ELL)
    deep = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    gen = torch.Generator(device=dev).manual_seed(8)
    worst = 0
    # name, ring, m, k, n, jr, encode, value rows
    for name, ring, m, k, n, jr, encode, vals in (
            ("toy", toy, 250, 64, 300, 1, "enc32", True),
            ("toy", toy, 97, 33, 129, 2, "enc64", False),
            ("toy, bare", toy, 64, 32, 256, 0, None, False),
            ("toy c2 rows", toy, N_RECEIVERS, K_DIM, 200, 2, "enc64", True),
            ("config-4", deep, 100, 40, 130, 2, "enc64", True),
            ("config-4", deep, 64, 32, 128, 1, "enc32", False),
            ("config-4, bare", deep, 33, 17, 200, 0, None, False),
            ("config-4", deep, 70, 64, 257, 1, "enc64", True)):
        planes, rd, noise, bound, enc = swapped_operands(ring, m, k, n, jr, encode, gen, dev)

        def got():
            settings.noise_value_mac = vals
            try:
                return fm.matmul_fold_swapped(planes, rd, ring, noise=noise, encode=enc,
                                              encode32=encode == "enc32", noise_bound=bound)
            finally:
                del settings.noise_value_mac

        worst = max(worst, compared(
            "swapped_vs_plain",
            {"kernel": fm.SWAPPED_KERNEL, "shape": f"{name} m={m} k={k} n={n}",
             "channels": ring.num_limbs * ring.degree, "nd": ring.num_digits, "jr": jr,
             "noise_rows": "values" if vals else "digits", "encode": encode or "none"},
            fm.SWAPPED_KERNEL, got,
            swapped_plain_by_limb(ring, planes, rd, noise, enc)))
        del planes, rd, noise, enc
    torch.cuda.empty_cache()
    return worst


def phase_pipelined_vs_plain(dev) -> int:
    """The pipelined kernel against its twin (kernel 1's) at reduced
    shapes: nd = 5 and 8, input planes and in-kernel v3k at jr = 1 and 2
    (the twin with the v3k planes; row and column offsets, some whose
    counters wrap mod 2^32), value and digit rows, the encode alone, both
    encodes, m and n off its 64 x 32 tile."""
    import torch

    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm, tfry
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    toy = get_ring(MODULI, ELL)
    deep = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    gen = torch.Generator(device=dev).manual_seed(9)
    worst = 0
    # name, ring, m, k, n, noise, jr, encode, value rows, (row, column) offsets
    for name, ring, m, k, n, kind, jr, encode, vals, offs in (
            ("toy", toy, 250, 64, 300, "planes", 1, "enc32", True, None),
            ("toy", toy, 97, 33, 129, "v3k", 2, "enc64", False, (0, 0)),
            ("toy", toy, 130, 32, 96, "v3k", 1, "enc32", True, ((1 << 32) - 2, 1 << 31)),
            ("toy, encode only", toy, 64, 32, 64, None, 1, "enc64", False, None),
            ("config-4", deep, 100, 40, 130, "v3k", 2, "enc64", True, (5, (1 << 32) - 7)),
            ("config-4", deep, 65, 32, 33, "planes", 2, "enc32", False, None),
            ("config-4", deep, 70, 64, 257, "v3k", 1, "enc64", False, (1 << 31, 3))):
        lhs_dig, band, noise, bound, enc = operands(ring, m, k, n, jr, encode, gen, dev)
        g = None
        if kind == "v3k":
            g = ((*V3K_KEY, *offs), jr, bound, "tfry")
            noise = tfry.v3k_noise_digit_planes(*V3K_KEY, offs[0], m, n, ring.degree, bound,
                                                offs[1], dev)
        elif kind is None:
            noise = bound = None

        def got():
            settings.noise_value_mac = vals
            settings.pipeline_fold = True
            try:
                return fm.matmul_fold_scaled(
                    None, band, ring, noise=None if g else noise, encode=enc, lhs_dig=lhs_dig,
                    encode32=encode == "enc32", gen_noise=g, noise_bound=bound)
            finally:
                del settings.noise_value_mac, settings.pipeline_fold

        worst = max(worst, compared(
            "pipelined_vs_plain",
            {"kernel": fm.PIPELINED_KERNEL, "shape": f"{name} m={m} k={k} n={n}",
             "channels": ring.num_limbs * ring.degree, "nd": ring.num_digits,
             "noise": kind or "none", "jr": jr if kind else 0, "offsets": offs,
             "noise_rows": "values" if vals else "digits", "encode": encode or "none"},
            fm.PIPELINED_KERNEL, got, fold_plain_by_limb(ring, band, lhs_dig, noise, enc)))
        del lhs_dig, band, noise, enc
    torch.cuda.empty_cache()
    return worst


def contraction_bound(ring, m: int, k: int, n: int, nbytes: int, int32_ops: float = 0) -> dict:
    """The least time of one fused product: its bytes (each input read and
    each output written once) against its operations, the int8 digit MACs at
    the int8 rate or ``int32_ops`` at the SMs' issue rate, whichever takes
    longer (the tensor cores and the INT32 lanes run side by side)."""
    macs = ring.num_limbs * ring.degree * m * n * k * ring.num_digits ** 2
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(2 * macs / INT8_OPS_PER_S, int32_ops / INT32_OPS_PER_S) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "int8_macs": macs,
            "int32_ops": int32_ops}


def phase_opt_in_timing(dev, card: str) -> dict:
    """Both new kernels at the full c2 shapes of the toy chain (CH = 16,
    m = n = 4096, kd = 1280, nd = 5) and config 4 (CH = 272, m = n = 1024,
    kd = 4096, nd = 8), 32-bit encode, bound 50: every output against the
    plain twin (one limb at a time), then the kernel, the twin and
    ``torch._int_mm`` of the same contraction (a yardstick the port never
    calls) timed, CUDA events, median of 3, beside the bound. The pipelined
    kernel draws v3k in-kernel; its twin draws the v3k planes and folds,
    and the pair it replaces, the generator and banded kernel 1, is timed
    in the same call."""
    import torch

    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm, tfry
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    out = {"swapped": {}, "pipelined": {}}
    for label, ring, m, k in (
            ("toy c2", get_ring(MODULI, ELL), N_RECEIVERS, K_DIM),
            ("config-4 c2", get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL),
             DEEP_N, DEEP_K)):
        L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
        n, kd = m, k * nd
        shape = f"c2 m={m} n={n} channels={L * S} kd={kd} nd={nd}"
        gen = torch.Generator(device=dev).manual_seed(10)

        # the pipelined kernel, in-kernel v3k
        lhs_dig, band, _, bound, enc = operands(ring, m, k, n, 1, "enc32", gen, dev)
        g = ((*V3K_KEY, 0, 0), 1, bound, "tfry")

        def pipelined(on: bool = True):
            settings.pipeline_fold = on
            try:
                return fm.matmul_fold_scaled(None, band, ring, encode=enc, lhs_dig=lhs_dig,
                                             encode32=True, gen_noise=g)
            finally:
                del settings.pipeline_fold

        def plain():
            planes = tfry.v3k_noise_digit_planes(*V3K_KEY, 0, m, n, S, bound, 0, dev)
            return fold_plain_by_limb(ring, band, lhs_dig, planes, enc)

        err = max(max_abs_err(pipelined(), plain()), max_abs_err(pipelined(), pipelined(False)))
        check(err == 0, f"the pipelined kernel differs from its twin at full-width {label}")
        torch.cuda.empty_cache()
        nbytes = lhs_dig.numel() + band.numel() + 8 * m * n + 8 * L * S * m * n
        out["pipelined"][label] = ratios({
            "phase": "opt_in_timing", "kernel": fm.PIPELINED_KERNEL, "shape": shape,
            "noise": "v3k in-kernel, jr=1", "card": card, "compared": "every output",
            "max_abs_err": err, **kernel_times(pipelined),
            "plain_ms": cuda_ms(plain, reps=3),
            "banded_plus_generator_ms": cuda_ms(lambda: pipelined(False), reps=3),
            "library_ms": cuda_ms(int_mm_banded(ring, lhs_dig, band), reps=3),
            **contraction_bound(ring, m, k, n, nbytes, m * n * S * V3K_OPS_PER_VALUE)})
        emit(out["pipelined"][label])
        del lhs_dig, band, enc
        torch.cuda.empty_cache()

        # kernel 1's swapped form, noise planes
        planes, rd, noise, bound, enc = swapped_operands(ring, m, k, n, 1, "enc32", gen, dev,
                                                         digits_only=True)

        def swapped():
            return fm.matmul_fold_swapped(planes, rd, ring, noise=noise, encode=enc,
                                          encode32=True, noise_bound=bound)

        def swapped_plain():
            return swapped_plain_by_limb(ring, planes, rd, noise, enc)

        err = max_abs_err(swapped(), swapped_plain())
        check(err == 0, f"the swapped kernel differs from its twin at full-width {label}")
        torch.cuda.empty_cache()
        a = planes.reshape(L * S, nd * m, kd)
        rt = rd.reshape(L * S, kd, n).transpose(1, 2).contiguous()    # column-major rhs

        def library():
            for c in range(L * S):
                torch._int_mm(a[c], rt[c].t())

        nbytes = planes.numel() + rd.numel() + noise.numel() + 8 * m * n + 8 * L * S * m * n
        out["swapped"][label] = ratios({
            "phase": "opt_in_timing", "kernel": fm.SWAPPED_KERNEL, "shape": shape,
            "noise": "planes, jr=1", "card": card, "compared": "every output",
            "max_abs_err": err, **kernel_times(swapped),
            "plain_ms": cuda_ms(swapped_plain, reps=3), "library_ms": cuda_ms(library, reps=3),
            **contraction_bound(ring, m, k, n, nbytes)})
        emit(out["swapped"][label])
        del planes, rd, noise, enc, a, rt
        torch.cuda.empty_cache()
    return out


def phase_dealer_path(phase: str, params, dev, card: str, seed: int, stream: str,
                      full_parties, threshold_parties=(), keys=None, route: str = "banded",
                      wrap_parties=(), **info):
    """One configuration through the entry points under ``stream`` and
    ``route`` ("banded", the default; "swapped", ``settings.swapped_form``;
    "pipelined", ``settings.pipeline_fold``): CRS and batch keygen of n
    parties (or ``keys`` = (gpk, secret coefficients) of an earlier path),
    the encryption operands, n dealers' shares in one batch, threshold
    decryption of the dealers whose index is not a multiple of 10 (at
    ceil(2n/3)) for ``threshold_parties`` and the abort one dealer below the
    threshold, full decryption for ``full_parties``, every share exact; with
    ``wrap_parties``, one more encryption of scalars half of them >= 2^63,
    decoded with the reference's `as i64` semantics. Per-stage ms, and the
    kernels' launches over the path and over each of keygen, the encryption
    and the wrap encryption, each gated by the route."""
    import torch

    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.errors import InsufficientValidCiphertexts
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.ops.ntt import signed_digit_count

    times, stage_launches = {}, {}
    n = params.n
    key = R.key(seed)
    rng = np.random.default_rng(seed)
    shares = rng.integers(0, 1 << 32, size=(n, n), dtype=np.uint64)
    wrap_sc = rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
    wrap_sc[::2] |= np.uint64(1 << 63)
    valid = [i for i in range(n) if i % 10]
    threshold = -(-2 * n // 3)

    def counted(name: str, fn):
        before = launches()
        out = timed(times, f"{name}_ms", fn)
        stage_launches[name] = {k: c - before[k] for k, c in launches().items()}
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    settings.noise_stream = stream
    settings.swapped_form = route == "swapped"
    settings.pipeline_fold = route == "pipelined"
    try:
        reset_launches()
        if keys is None:
            crs = timed(times, "crs_ms", lambda: P.PvwCrs.new(params, R.fold_in(key, 0),
                                                              device=dev))
            coeffs = P.sample_vec_cbd(R.fold_in(key, 10_000), (n, params.k, params.l),
                                      params.secret_variance, device=dev)
            gpk = P.GlobalPublicKey(crs)
            counted("keygen", lambda: gpk.generate_all_keys_device(coeffs, R.fold_in(key, 1)))
            host_coeffs = coeffs.cpu().numpy()
            del coeffs
        else:
            gpk, host_coeffs = keys
        timed(times, "operands_ms", gpk.encrypt_operands_swapped if route == "swapped"
              else gpk.encrypt_operands)
        ct = counted("encrypt", lambda: P.encrypt_all_party_shares_batched(
            shares, gpk, R.fold_in(key, 777)))
        sks = {i: P.SecretKey(params, host_coeffs[i])
               for i in (*full_parties, *threshold_parties, *wrap_parties)}
        got = {i: timed(times, f"threshold_decrypt_party_{i}_ms",
                        lambda: P.decrypt_valid_shares(ct, valid, threshold, sks[i], i))
               for i in threshold_parties}
        aborted = None
        if threshold_parties:
            i = threshold_parties[0]
            try:
                P.decrypt_valid_shares(ct, valid[:threshold - 1], threshold, sks[i], i)
                aborted = False
            except InsufficientValidCiphertexts:
                aborted = True
        full = {i: timed(times, f"decrypt_party_{i}_ms",
                         lambda: P.decrypt_party_shares(ct, sks[i], i))
                for i in full_parties}
        wrap_got = {}
        if wrap_parties:
            wrap_ct = counted("wrap_encrypt", lambda: P.encrypt(wrap_sc, gpk,
                                                                R.fold_in(key, 778)))
            wrap_got = {i: P.decrypt_party_value(wrap_ct, sks[i], i) for i in wrap_parties}
        counts = launches()
        # the first full party's shares again, by the Python decode
        settings.decode_mode = "python"
        i = full_parties[0]
        python_equal = P.decrypt_party_shares(ct, sks[i], i) == full[i]
    finally:
        del settings.noise_stream, settings.swapped_form, settings.pipeline_fold
        del settings.decode_mode
    from pvw_tpu_torch.utils import native_decode

    # the batches (threshold subsets and every dealer) decode on the card; a
    # single message in the C++ engine where it covers the parameters
    host_wrap = len(wrap_parties) if native_decode.decrypt_decode_supported(params) else 0
    decryptions = len(threshold_parties) + len(full_parties) + len(wrap_parties) - host_wrap
    shares_exact = all(got[i] == [(dl, int(shares[dl, i])) for dl in valid]
                       for i in threshold_parties) \
        and all(full[i] == [int(v) for v in shares[:, i]] for i in full_parties)
    q = params.q_total()
    wrap_ok = all(wrap_got[i] == expected_wrapped(int(wrap_sc[i]), q) for i in wrap_parties)
    ring = params.ring
    out = {"phase": phase, "card": card, **info, "stream": stream, "route": route, "n": n,
           "k": params.k, "l": params.l, "limbs": ring.num_limbs,
           "q_bits": params.q_total().bit_length(), "nd": ring.num_digits,
           "variance": params.secret_variance,
           "error_bounds": [params.error_bound_1, params.error_bound_2],
           "keys": "fresh" if keys is None else "reused", "dealers": n,
           "threshold_parties": list(threshold_parties),
           "valid_dealers": len(valid) if threshold_parties else None,
           "threshold": threshold if threshold_parties else None,
           "aborted_below_threshold": aborted, "full_parties": list(full_parties), **times,
           "enc_per_s": n / (times["encrypt_ms"] / 1e3), "shares_exact": shares_exact,
           "wrap_scalars": {str(i): int(wrap_sc[i]) for i in wrap_parties},
           "wrap_decoded": {str(i): wrap_got[i] for i in wrap_parties},
           "wrap_ok": wrap_ok if wrap_parties else None,
           "decryptions": decryptions, "device_decodes": counts[DECODES],
           "host_decrypts": counts[HOST_DECRYPTS],
           "python_decode_equal": python_equal,
           "launches": counts, "encrypt_launches": stage_launches["encrypt"],
           "stage_launches": stage_launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    check(shares_exact, f"a decrypted share differs from the encrypted one ({phase})")
    check(aborted is not False, f"{threshold - 1} valid dealers did not abort at threshold "
                                f"{threshold} ({phase})")
    check(wrap_ok, f"the >= 2^63 scalars did not decode with `as i64` semantics ({phase})")
    check(counts[DECODES] == decryptions, f"{counts[DECODES]} device decodes for "
                                          f"{decryptions} decryptions in {phase}")
    check(counts[DECODE_KERNEL] == counts[DECODES],
          f"the decode kernel launched {counts[DECODE_KERNEL]} times for {counts[DECODES]} "
          f"device decodes in {phase}")
    check(counts[fm.CONTRACTION_KERNEL] == counts[DECODES],
          f"the contraction kernel launched {counts[fm.CONTRACTION_KERNEL]} times for "
          f"{counts[DECODES]} device decryptions in {phase}")
    check(counts[HOST_DECRYPTS] == host_wrap, f"{counts[HOST_DECRYPTS]} host decryptions for "
                                              f"{host_wrap} single messages in {phase}")
    check(counts[NATIVE_DECODES] == counts[PYTHON_DECODES] == 0,
          f"the C++ or the Python decode ran on {phase} before its Python check")
    check(python_equal, f"the device decode differs from the Python decode in {phase}")
    check(counts[RELAYOUTS] == 0, f"{counts[RELAYOUTS]} bands were relaid to k-packed in "
                                  f"{phase}: kernel 4 writes every band so")
    check(counts[ROW_RELAYOUTS] == 0, f"{counts[ROW_RELAYOUTS]} lhs operands were copied to "
                                      f"16-byte rows in {phase}: the key cache lays them out")
    for name in probe_kernels():
        check(counts[name] == 0, f"the probe kernel {name} launched {counts[name]} times in "
                                 f"{phase}")
    # the route's kernels ran in each stage, and the other routes' kernels did not
    product = {"banded": fm.KERNEL, "swapped": fm.SWAPPED_KERNEL,
               "pipelined": fm.PIPELINED_KERNEL}
    generated = sum(1 for b in (params.error_bound_1, params.error_bound_2)
                    if signed_digit_count(b))
    # products whose bound takes the residue-noise generator
    residue = [not signed_digit_count(b) and b < min(params.ring.moduli)
               for b in (params.error_bound_1, params.error_bound_2)]
    for stage in ("encrypt", "wrap_encrypt"):
        if stage not in stage_launches:
            continue
        ran = stage_launches[stage]
        check(ran[fm.RESIDUE_NOISE_KERNEL] == sum(residue),
              f"the residue-noise generator ran {ran[fm.RESIDUE_NOISE_KERNEL]} times in the "
              f"{stage} stage of {phase}, which has {sum(residue)} products with residue noise")
        check(ran[product[route]] >= 2, f"{product[route]} ran {ran[product[route]]} times "
                                        f"in the {stage} stage of {phase}")
        for other in (set(product.values()) - {product[route]}) | {fm.MASKED_KERNEL,
                                                                    fm.BANDED_KERNEL}:
            check(ran[other] == 0, f"{other} ran {ran[other]} times in the {stage} stage of "
                                   f"{phase}, whose route is {route}")
        if route == "swapped":
            check(ran[fm.PRESCALE_KERNEL] == 0, f"the r-stage kernel ran in {phase}'s "
                                                 "swapped encryption")
        else:
            check(ran[fm.PRESCALE_KERNEL] >= 1, f"the r-stage kernel never ran in the {stage} "
                                                 f"stage of {phase}")
        if route == "pipelined":
            check(ran[fm.NOISE_KERNEL] == 0, f"the v3k generator ran {ran[fm.NOISE_KERNEL]} "
                                             f"times in {phase}'s pipelined {stage} stage")
        elif stage == "encrypt" and stream == "v3k":
            check(ran[fm.NOISE_KERNEL] >= generated,
                  f"the v3k generator ran {ran[fm.NOISE_KERNEL]} times in the encryption of "
                  f"{phase}, which has {generated} products with signed-digit noise")
        elif stage == "encrypt":
            check(ran[fm.NOISE_KERNEL] == 0, f"the v3k generator ran in the encryption of "
                                             f"{phase} under stream {stream}")
    if "keygen" in stage_launches:
        keygen = fm.PIPELINED_KERNEL if route == "pipelined" else fm.KERNEL
        check(stage_launches["keygen"][keygen] >= 1, f"{keygen} never ran in the keygen of "
                                                     f"{phase}")
        drew = stage_launches["keygen"][fm.RESIDUE_NOISE_KERNEL]
        check(drew >= 1 if residue[0] else drew == 0,
              f"the residue-noise generator ran {drew} times in the keygen of {phase}")
    return out, {"params": params, "gpk": gpk, "shares": shares,
                 "sk": sks[full_parties[0]], "coeffs": host_coeffs}


# --------------------------------------------------------------------------
# kernel 1's masked form and post=, kernel 2, and the multi-device backends
# --------------------------------------------------------------------------

def phase_masked_vs_plain(dev) -> dict:
    """Kernel 1's masked form (the generator's masked planes, then the
    encode on the global rows [lo, hi) only) and its ``post=`` addmod
    against the twin at reduced shapes: nd = 5 and 8, jr = 1 and 2, value
    and digit rows, ranges empty, full, ragged and off the 128-row tile,
    column offsets in seed word 5, and with ``post=``; ``post=`` alone and
    with the noise and the encode. Every output byte; worst differences by
    form."""
    import torch

    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    toy = get_ring(MODULI, ELL)
    deep = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    gen = torch.Generator(device=dev).manual_seed(11)
    worst = {"masked": 0, "post": 0}
    # name, ring, m, k, n, jr, encode, value rows, row offset, [lo, hi), column
    # offset, with post=
    for name, ring, m, k, n, jr, encode, vals, row_off, rng_, col_off, with_post in (
            ("toy, ragged first part", toy, 250, 64, 300, 1, "enc32", True, 0, (0, 97), 0,
             False),
            ("toy, its complement", toy, 250, 64, 300, 2, "enc64", False, 0, (97, 250), 7,
             False),
            ("toy, empty", toy, 130, 32, 96, 1, "enc64", True, 500, (0, 0), 0, False),
            ("config-4, full", deep, 100, 40, 130, 2, "enc64", True, 5, (0, 1 << 30), 3,
             False),
            ("config-4, off the tile", deep, 300, 64, 257, 1, "enc32", False, 128, (200, 331),
             0, False),
            ("config-4, ragged", deep, 65, 32, 33, 2, "enc32", False, 1000, (1010, 1033),
             1 << 31, False),
            ("toy, ragged, with post", toy, 250, 64, 300, 2, "enc64", True, 3, (40, 190), 5,
             True),
            ("config-4, off the tile, with post", deep, 300, 64, 257, 1, "enc32", False, 128,
             (200, 331), 0, True)):
        lhs_dig, band, _, bound, enc = operands(ring, m, k, n, jr, encode, gen, dev)
        g = ((*V3K_KEY, row_off, *rng_, col_off), jr, bound, "tfry")
        planes = fm.v3k_noise_planes_plain(*V3K_KEY, row_off, m, n, ring.degree, bound,
                                           col_off, dev, mask=rng_)
        post = None
        if with_post:
            q = ring.table("q", dev).reshape(-1, 1, 1, 1)
            post = torch.randint(0, 1 << 62, (ring.num_limbs, ring.degree, m, n),
                                 generator=gen, device=dev) % q

        def got():
            settings.noise_value_mac = vals
            try:
                return fm.matmul_fold_scaled(None, band, ring, encode=enc, lhs_dig=lhs_dig,
                                             encode32=encode == "enc32", gen_noise=g,
                                             post=post)
            finally:
                del settings.noise_value_mac

        worst["masked"] = max(worst["masked"], compared(
            "masked_vs_plain",
            {"kernel": fm.MASKED_KERNEL, "shape": f"{name} m={m} k={k} n={n}",
             "channels": ring.num_limbs * ring.degree, "nd": ring.num_digits, "jr": jr,
             "rows": [row_off, *rng_], "col_off": col_off,
             "noise_rows": "values" if vals else "digits", "encode": encode,
             "post": with_post},
            fm.MASKED_KERNEL, got,
            fold_plain_by_limb(ring, band, lhs_dig, planes, enc, post=post,
                               mask=(row_off, *rng_))))
        del lhs_dig, band, enc, planes, post
    # post=: name, ring, m, k, n, jr (0: no noise), encode
    for name, ring, m, k, n, jr, encode in (
            ("toy, post alone", toy, 250, 64, 300, 0, None),
            ("config-4, post with noise and the encode", deep, 100, 40, 130, 2, "enc64")):
        lhs_dig, band, noise, bound, enc = operands(ring, m, k, n, jr, encode, gen, dev)
        noise, bound = (noise, bound) if jr else (None, None)
        q = ring.table("q", dev).reshape(-1, 1, 1, 1)
        post = torch.randint(0, 1 << 62, (ring.num_limbs, ring.degree, m, n), generator=gen,
                             device=dev) % q
        worst["post"] = max(worst["post"], compared(
            "masked_vs_plain",
            {"kernel": f"{fm.KERNEL} (post=)", "shape": f"{name} m={m} k={k} n={n}",
             "channels": ring.num_limbs * ring.degree, "nd": ring.num_digits, "jr": jr,
             "encode": encode or "none"},
            fm.KERNEL,
            lambda: fm.matmul_fold_scaled(None, band, ring, noise=noise, encode=enc,
                                          lhs_dig=lhs_dig, noise_bound=bound, post=post),
            fold_plain_by_limb(ring, band, lhs_dig, noise, enc, post=post)))
        del lhs_dig, band, noise, enc, post
    torch.cuda.empty_cache()
    return worst


def channels_plain_by_limb(ring, a, b):
    """Kernel 2's plain twin, ``modmat.matmul_channels``, one limb at a time."""
    from pvw_tpu_torch.ops import modmat

    return plain_by_limb(ring, lambda lhs, rhs, sub, nz, enc: modmat.matmul_channels(
        lhs, rhs, sub), a, b)


def phase_banded_vs_plain(dev) -> int:
    """Kernel 2 through ``matmul_channels_fused`` against its twin at
    reduced shapes: C = 9 (toy chain) and 15 (config 4's chain), m and n off
    its 64 x 32 tile, k a multiple of 16 and odd. Every output."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    toy = get_ring(MODULI, ELL)
    deep = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = 0
    for name, ring, m, k, n in (("toy", toy, 250, 64, 300), ("toy", toy, 97, 33, 129),
                                ("toy, c2 rows", toy, N_RECEIVERS, K_DIM, 200),
                                ("config-4", deep, 100, 40, 130),
                                ("config-4", deep, 65, 17, 33),
                                ("config-4, c2 rows", deep, DEEP_N, DEEP_K, 96)):
        a, b = residue_pair(ring, m, k, n, gen, dev)
        worst = max(worst, compared(
            "banded_vs_plain",
            {"kernel": fm.BANDED_KERNEL, "shape": f"{name} m={m} k={k} n={n}",
             "channels": ring.num_limbs * ring.degree, "nd": ring.num_digits,
             "columns": 2 * ring.num_digits - 1},
            fm.BANDED_KERNEL, lambda: fm.matmul_channels_fused(a, b, ring),
            channels_plain_by_limb(ring, a, b)))
        del a, b
    torch.cuda.empty_cache()
    return worst


def residue_pair(ring, m, k, n, gen, dev):
    """Random canonical residues lhs [L, l, m, k] and rhs [L, l, k, n] on the card."""
    import torch

    q = ring.table("q", dev).reshape(-1, 1, 1, 1)
    shape = (ring.num_limbs, ring.degree)
    return (torch.randint(0, 1 << 62, (*shape, m, k), generator=gen, device=dev) % q,
            torch.randint(0, 1 << 62, (*shape, k, n), generator=gen, device=dev) % q)


def digit_planes_bound(m: int, k: int, n: int, ch: int, nd: int) -> dict:
    """The least time of kernel 2's operand layout for one product: the
    residues of both operands read (8 bytes each) and their digit planes
    written (nd bytes an element, rows padded to 16 bytes), once."""
    k_pad = -(-k // 16) * 16
    nbytes = ch * (8 * (m * k + k * n) + nd * (m + n) * k_pad)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": bytes_ms, "bound_by": "bytes", "bytes": nbytes, "bytes_ms": bytes_ms}


def phase_banded(dev, card: str) -> tuple[dict, dict, dict]:
    """Kernel 2 at the two full shapes, [16 ch, 4096 x 256] x [256 x 1024]
    (toy chain, nd = 5, the JAX docstring's) and [272 ch, 1024 x 512] x
    [512 x 1024] (config 4's chain, nd = 8). ``banded_path``: the entry
    ``matmul_fold_auto`` at both, the launch counts set to 0 before and read
    after (kernel 2 once, its layout kernel twice), every output against
    the twin (one limb at a time). Then ``banded_timing``: the layout
    kernel's planes against its twin, byte for byte; the kernel launch
    alone (median of 5 with the spread), the entry, the layout (both
    operands, kernel and twin), the twin and ``torch._int_mm`` of the nd^2
    digit products (a yardstick the port never calls), CUDA events, medians
    of 3 (the twin once at config 4), beside the bound of the nd^2 useful
    products; and ``digits_timing``: the layout kernel's two launches beside
    their bytes' bound."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    gen = torch.Generator(device=dev).manual_seed(13)
    shapes = (("toy", get_ring(MODULI, ELL), *BANDED_TOY),
              ("config-4", get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL),
               DEEP_N, DEEP_K, DEEP_N))
    path, timing, digits = {"phase": "banded_path", "card": card, "shapes": {}}, {}, {}
    reset_launches()
    for label, ring, m, k, n in shapes:
        a, b = residue_pair(ring, m, k, n, gen, dev)
        before = launches()
        out = timed(path["shapes"].setdefault(label, {}), "entry_ms",
                    lambda: fm.matmul_fold_auto(a, b, ring))
        ran = {name: c - before[name] for name, c in launches().items()}
        err = max_abs_err(out, channels_plain_by_limb(ring, a, b))
        path["shapes"][label].update({"m": m, "k": k, "n": n, "launches": ran,
                                      "max_abs_err": err})
        check(err == 0, f"kernel 2 differs from its twin at the full {label} shape")
        check(ran[fm.BANDED_KERNEL] == 1 and ran[fm.DIGITS_KERNEL] == 2
              and sum(ran.values()) == 3, f"matmul_fold_auto launched {ran} at the {label} shape")
        del a, b, out
        torch.cuda.empty_cache()
    path["launches"] = launches()
    emit(path)
    for label, ring, m, k, n in shapes:
        L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
        a, b = residue_pair(ring, m, k, n, gen, dev)
        lhs, rhs = a.reshape(L * S, m, k), b.reshape(L * S, k, n)

        def layout(split=fm.digit_planes_kpacked):
            return split(lhs, nd), split(rhs, nd, transpose=True)

        ap, bp = layout()
        want = layout(fm.digit_planes_kpacked_plain)
        digits_err = max(max_abs_err(ap, want[0]), max_abs_err(bp, want[1]))
        check(digits_err == 0, f"the digit planes differ from their twin at the {label} shape")
        del want
        tables = fm._banded_tables(ring, S, dev)
        a_int = ap.reshape(L * S, nd * m, k)               # k_pad = k at both shapes
        b_int = bp.reshape(L * S, nd * n, k)               # column-major rhs, as cuBLASLt takes

        def library():
            for c in range(L * S):
                torch._int_mm(a_int[c], b_int[c].t())

        twin_ms = cuda_ms(lambda: channels_plain_by_limb(ring, a, b), reps=1 if L > 2 else 3,
                          warmup=0)
        layout_ms = cuda_ms(layout, reps=3)
        layout_plain_ms = cuda_ms(lambda: layout(fm.digit_planes_kpacked_plain), reps=3)
        nbytes = 8 * L * S * (m * k + k * n + m * n)       # residues in, residues out
        shape = f"[{L * S} ch, {m} x {k}] x [{k} x {n}] nd={nd}"
        timing[label] = ratios({
            "phase": "banded_timing", "kernel": fm.BANDED_KERNEL,
            "shape": f"{shape} C={2 * nd - 1}", "card": card,
            "max_abs_err": path["shapes"][label]["max_abs_err"],
            **kernel_times(lambda: fm.banded_matmul(ap, bp, tables)),
            "entry_ms": cuda_ms(lambda: fm.matmul_channels_fused(a, b, ring), reps=3),
            "layout_ms": layout_ms, "layout_plain_ms": layout_plain_ms,
            "plain_ms": twin_ms, "plain": "one limb at a time",
            "library_ms": cuda_ms(library, reps=3),
            "library": "torch._int_mm of the nd^2 digit products, one channel at a time",
            **contraction_bound(ring, m, k, n, nbytes),
            "bound_counts": "the nd^2 useful digit products; the kernel's windows run "
                            f"{2 * nd - 1}/{nd} of them"})
        timing[label]["x_bound_entry"] = timing[label]["entry_ms"] / timing[label]["bound_ms"]
        emit(timing[label])
        digits[label] = ratios({
            "phase": "digits_timing", "kernel": fm.DIGITS_KERNEL,
            "shape": f"both operands of {shape}", "card": card, "max_abs_err": digits_err,
            **kernel_times(layout), "plain_ms": layout_plain_ms, "library_ms": None,
            **digit_planes_bound(m, k, n, L * S, nd)})
        emit(digits[label])
        del a, b, lhs, rhs, ap, bp, a_int, b_int
        torch.cuda.empty_cache()
    return path, timing, digits


def phase_masked_timing(dev, card: str) -> dict:
    """Kernel 1's masked form and its ``post=`` addmod at the full c2 shapes
    of the toy chain (CH = 16, m = n = 4096, kd = 1280) and config 4 (CH =
    272, m = n = 1024, kd = 4096), bound 50, through ``matmul_fold_scaled``:
    the masked form with 6-word v3k seeds on the rows [m/4, 3m/4) (a (2, 2)
    mesh shard's block; the generator's masked planes, then the masked
    launch) and the 32-bit encode, and post= on the bare product. Every
    output against the twin (one limb at a time), then both timed (CUDA
    events, median of 5 with the spread) beside the twin, ``torch._int_mm``
    of the contraction and the bound. -> {form: {shape label: record}}."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    out = {"masked": {}, "post": {}}
    for label, ring, m, k in (
            ("toy c2", get_ring(MODULI, ELL), N_RECEIVERS, K_DIM),
            ("config-4 c2", get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL),
             DEEP_N, DEEP_K)):
        L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
        n = m
        gen = torch.Generator(device=dev).manual_seed(14)
        lhs_dig, band, _, bound, enc = operands(ring, m, k, n, 1, "enc32", gen, dev)
        lo, hi = m // 4, 3 * m // 4
        g = ((*V3K_KEY, 0, lo, hi, 0), 1, bound, "tfry")
        q = ring.table("q", dev).reshape(-1, 1, 1, 1)
        post = torch.randint(0, 1 << 62, (L, S, m, n), generator=gen, device=dev) % q
        form = {
            "masked": (fm.MASKED_KERNEL, lambda: fm.matmul_fold_scaled(
                None, band, ring, encode=enc, lhs_dig=lhs_dig, encode32=True, gen_noise=g),
                lambda: fold_plain_by_limb(ring, band, lhs_dig, fm.v3k_noise_planes_plain(
                    *V3K_KEY, 0, m, n, S, bound, 0, dev, mask=(lo, hi)), enc,
                    mask=(0, lo, hi)),
                L * S * m * n * 8 + m * n * (8 + S)),
            "post": (f"{fm.KERNEL} (post=)", lambda: fm.matmul_fold_scaled(
                None, band, ring, lhs_dig=lhs_dig, post=post),
                lambda: fold_plain_by_limb(ring, band, lhs_dig, post=post),
                2 * L * S * m * n * 8)}
        for name, (kernel, launch, twin, io_bytes) in form.items():
            err = max_abs_err(launch(), twin())
            check(err == 0, f"kernel 1's {name} form differs from its twin at {label}")
            torch.cuda.empty_cache()
            out[name][label] = ratios({
                "phase": "masked_timing", "kernel": kernel,
                "shape": f"c2 m={m} n={n} channels={L * S} kd={k * nd} nd={nd}"
                         + (f", rows [{lo}, {hi})" if name == "masked" else ""),
                "card": card, "compared": "every output", "max_abs_err": err,
                **kernel_times(launch), "plain_ms": cuda_ms(twin, reps=3),
                "plain": "one limb at a time",
                "library_ms": cuda_ms(int_mm_banded(ring, lhs_dig, band), reps=3),
                **contraction_bound(ring, m, k, n,
                                    lhs_dig.numel() + band.numel() + io_bytes)})
            emit(out[name][label])
            torch.cuda.empty_cache()
        del lhs_dig, band, enc, post
        torch.cuda.empty_cache()
    return out


def phase_backends(dev, card: str, params, keys, stream: str, seed: int,
                   devices=None) -> dict:
    """The multi-device backends at config 4 (``threshold_256bit(1024)``,
    1024 dealers) on the config-4 keys under ``stream``, each a path: the
    launch counts set to 0 before its encryption and read after, gated, its
    c1 and c2 ``torch.equal`` to the single-device ciphertext of the same
    key and scalars (encrypted first, outside the counts), sampled parties'
    shares exact and equal to the single-device decryption by the Python
    decode, the device decodes of each backend's decryption counted (one
    per recv row of a mesh, one for the gathered limbs or dealers),
    host-clocked encryption and decryption, enc/s and peak device memory.
    Under v3k: ``sharded_path`` (a (2, 2) mesh over cuda:0
    repeated four times), ``forced_masked_path`` ((1, 1), ``_force_masked``),
    ``data_parallel_path`` (4 dealer shards), ``limb_parallel_path`` (17
    limbs in 4 groups) and ``grid_path`` (2 limb groups x a (1, 2) mesh);
    under the default stream ``sharded_bake_path`` ((2, 2), the bake
    route). ``devices``: the four shard devices (default ``dev`` four
    times; the keys and the single-device encryption stay on ``dev``); peak
    memory is ``dev``'s."""
    import torch

    import pvw_tpu_torch as P
    import pvw_tpu_torch.parallel as TP
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm

    gpk, host_coeffs = keys
    n = params.n
    rng = np.random.default_rng(seed)
    shares = rng.integers(0, 1 << 32, size=(n, n), dtype=np.uint64)
    key = R.fold_in(R.key(seed), 777)
    sks = {i: P.SecretKey(params, host_coeffs[i]) for i in (0, 1, n // 2, n - 1)}
    v3k = stream == "v3k"
    # name: (encrypt, decrypt(ct, party), parties decrypted, shards, products, masked
    # launches, device decodes a decryption, contraction launches a decryption); a
    # mesh computes c1 on its recv row 0 only, c2 on every shard, decodes a batch
    # per recv row and contracts a k block per shard
    devices = list(devices) if devices is not None else [dev] * 4
    mesh = lambda count, kdim: TP.make_mesh(devices[:count], kdim=kdim)
    backends = {
        "sharded_path" if v3k else "sharded_bake_path": (
            lambda: TP.encrypt_batch_sharded(shares, gpk, key, mesh(4, 2)),
            lambda ct, i: TP.decrypt_party_shares_sharded(ct, sks[i], i, mesh(4, 2)),
            (0, n - 1), 4, 6, 6 if v3k else 0, 2, 4)}
    if v3k:
        backends.update({
            "forced_masked_path": (
                lambda: TP.encrypt_batch_sharded(shares, gpk, key, mesh(1, 1),
                                                 _force_masked=True),
                lambda ct, i: TP.decrypt_party_shares_sharded(ct, sks[i], i, mesh(1, 1)),
                (n // 2,), 1, 2, 2, 1, 1),
            "data_parallel_path": (
                lambda: TP.encrypt_batch_data_parallel(shares, gpk, key, devices),
                lambda ct, i: P.decrypt_party_shares(ct.gather(), sks[i], i), (1,), 4, 8, 0,
                1, 1),
            "limb_parallel_path": (
                lambda: TP.encrypt_batch_limb_parallel(shares, gpk, key, devices),
                lambda ct, i: TP.decrypt_party_shares_limb_parallel(ct, sks[i], i), (0,), 4, 8,
                0, 1, 4),
            "grid_path": (
                lambda: TP.encrypt_batch_grid(shares, gpk, key, devices, limb_groups=2,
                                              kdim=2),
                lambda ct, i: TP.decrypt_party_shares_grid(ct, sks[i], i), (n - 1,), 4, 8, 8,
                1, 4)})
    settings.noise_stream = stream
    out = {}
    try:
        gpk.encrypt_operands()
        times = {}
        ref = timed(times, "single_device_encrypt_ms",
                    lambda: P.encrypt_all_party_shares_batched(shares, gpk, key))
        ref1, ref2 = ref.c1.channel(), ref.c2.channel()
        # every decrypted party's shares from the single-device ciphertext, by
        # the Python decode
        settings.decode_mode = "python"
        try:
            single = {i: P.decrypt_party_shares(ref, sks[i], i)
                      for i in sorted({i for b in backends.values() for i in b[2]})}
        finally:
            del settings.decode_mode
        del ref
        for name, (encrypt, decrypt, parties, nshards, products, masked,
                   decodes, contractions) in backends.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = {"single_device_encrypt_ms": times["single_device_encrypt_ms"]}
            reset_launches()
            ct = timed(t, "encrypt_ms", encrypt)
            ran = launches()
            peak = torch.cuda.max_memory_allocated() / 1e9
            whole = ct if isinstance(ct, P.PvwCiphertext) else ct.gather()
            equal = (torch.equal(whole.c1.channel(), ref1)
                     and torch.equal(whole.c2.channel(), ref2))
            del whole
            reset_launches()
            got = {i: timed(t, f"decrypt_party_{i}_ms", lambda: decrypt(ct, i)) for i in parties}
            decoded, decode_launches, contracted = (
                launches()[k] for k in (DECODES, DECODE_KERNEL, fm.CONTRACTION_KERNEL))
            exact = all(got[i] == [int(v) for v in shares[:, i]] for i in parties)
            python_equal = all(got[i] == single[i] for i in parties)
            out[name] = {"phase": name, "card": card, "devices": [str(d) for d in devices],
                         "config": "BASELINE config 4",
                         "preset": "threshold_256bit", "stream": stream, "dealers": n,
                         "shards": nshards, **t,
                         "enc_per_s": n / (t["encrypt_ms"] / 1e3),
                         "single_device_enc_per_s": n / (t["single_device_encrypt_ms"] / 1e3),
                         "equal_to_single_device": equal, "parties": list(parties),
                         "shares_exact": exact, "equal_to_single_device_python_decode":
                         python_equal, "device_decodes": decoded,
                         "contraction_launches": contracted,
                         "launches": ran, "peak_mem_gb": peak}
            emit(out[name])
            del ct
            torch.cuda.empty_cache()
            check(equal, f"{name}: the ciphertext differs from the single-device one")
            check(exact, f"{name}: a decrypted share differs from the encrypted one")
            check(python_equal, f"{name}: a decrypted share differs from the single-device "
                                "decryption by the Python decode")
            check(decoded == decodes * len(parties),
                  f"{name}: {decoded} device decodes for {len(parties)} decryptions "
                  f"({decodes} each)")
            check(decode_launches == decoded,
                  f"{name}: the decode kernel launched {decode_launches} times for {decoded} "
                  f"device decodes")
            check(contracted == contractions * len(parties),
                  f"{name}: the contraction kernel launched {contracted} times for "
                  f"{len(parties)} decryptions ({contractions} each)")
            check(ran[fm.MASKED_KERNEL] == masked,
                  f"{name}: the masked form launched {ran[fm.MASKED_KERNEL]} times, not {masked}")
            check(ran[RELAYOUTS] == 0, f"{name}: {ran[RELAYOUTS]} bands relaid to k-packed")
            check(ran[ROW_RELAYOUTS] == 0,
                  f"{name}: {ran[ROW_RELAYOUTS]} lhs operands copied to 16-byte rows")
            check(ran[fm.PRESCALE_KERNEL] == nshards,
                  f"{name}: kernel 4 launched {ran[fm.PRESCALE_KERNEL]} times for {nshards} shards")
            for other in (fm.PIPELINED_KERNEL, fm.SWAPPED_KERNEL, fm.BANDED_KERNEL,
                          *probe_kernels()):
                check(ran[other] == 0, f"{name}: {other} launched {ran[other]} times")
            check(ran[fm.KERNEL] == products,
                  f"{name}: {ran[fm.KERNEL]} product launches for {products} products")
            check(ran[fm.NOISE_KERNEL] == (products if v3k else 0),
                  f"{name}: the v3k generator launched {ran[fm.NOISE_KERNEL]} times")
            if not v3k:
                check(ran[BARE] == products, f"{name}: the bake route launched kernel 1 bare "
                                             f"{ran[BARE]} times of {products}")
    finally:
        del settings.noise_stream
    del ref1, ref2
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------
# the probes' kernels (pvw_tpu_torch/benchmarks): the two-pass product, the
# int32 peak and kernel 1's contraction in three band layouts, each at the
# dealer paths' c2 shapes; no dealer path launches them
# --------------------------------------------------------------------------

def fold_only_plain_by_limb(ring, cols):
    """The fold kernel's plain version, one limb (S channels) at a time."""
    import torch

    from pvw_tpu_torch.benchmarks import probe_twopass as tp
    from pvw_tpu_torch.params.ring import get_ring

    S = ring.degree
    return torch.cat([tp.fold_only_plain(cols[i * S:(i + 1) * S], get_ring((q,), S))
                      for i, q in enumerate(ring.moduli)])


def probe_launches_only(ran: dict, allowed: dict, what: str) -> None:
    """Gate a probe path's launches: exactly ``allowed`` {kernel: count},
    every other kernel none (relayout counts are not kernels)."""
    for name, count in ran.items():
        if name in (RELAYOUTS, ROW_RELAYOUTS):
            continue
        check(count == allowed.get(name, 0), f"{what}: {name} launched {count} times, "
                                             f"not {allowed.get(name, 0)}")


def phase_twopass(dev, card: str) -> tuple[dict, int, dict]:
    """The two-pass c2 product (``pvw_tpu_torch.benchmarks.probe_twopass``).
    ``twopass_vs_plain``: the fold kernel ``fold_only`` against its plain
    version at reduced shapes (nd = 5 and 8, m and n off its 256-column
    block) over int32 columns across the whole int32 range. ``twopass_path``
    at the toy and config-4 c2 shapes: the launch counts set to 0, the
    probe's path (A: kernel 1 bare; B: ``torch._int_mm`` into the int32
    columns, no copy; C: ``fold_only`` of them), the counts read: kernel 1
    (bare) and ``fold_only`` once a shape, nothing else; C == A and
    ``fold_only`` == its plain version (one limb at a time), every residue.
    ``twopass_timing``: A, B, C and pass 2 alone (CUDA events, median of 5
    with the spread) beside their bounds (pass 2 by its bytes, C by the
    int8 operations plus pass 2's bytes) and pass 2's plain version, and the
    probe's verdict. -> (the path record, the worst difference, {label:
    timing record})."""
    import torch

    from pvw_tpu_torch.benchmarks import C2_SHAPES, c2_shape, probe_twopass as tp
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils.intmath import generate_ntt_primes

    gen = torch.Generator(device=dev).manual_seed(15)
    worst = 0
    deep = get_ring(generate_ntt_primes(*DEEP_PRIMES, DEEP_ELL), DEEP_ELL)
    for name, ring, m, n in (("toy chain", get_ring(MODULI, ELL), 37, 1000),
                             ("config-4 chain", deep, 5, 333)):
        nd = ring.num_digits
        cols = torch.randint(-(1 << 31), 1 << 31, (ring.num_limbs * ring.degree, m, nd, n),
                             generator=gen, device=dev)
        cols[0, 0, :, 0], cols[-1, -1, :, -1] = -(1 << 31), (1 << 31) - 1
        cols = cols.to(torch.int32)
        err = max_abs_err(tp.fold_only(cols, ring), fold_only_plain_by_limb(ring, cols))
        worst = max(worst, err)
        emit({"phase": "twopass_vs_plain", "kernel": FOLD_ONLY_KERNEL,
              "shape": f"{name} CH={cols.shape[0]} m={m} nd={nd} n={n}",
              "columns": "the whole int32 range", "bit_exact": err == 0, "max_abs_err": err})
        check(err == 0, f"fold_only differs from its plain version at the {name} shape")
        del cols
    path = {"phase": "twopass_path", "card": card, "shapes": {},
            "launches": dict.fromkeys(launches(), 0)}
    timing = {}
    reset_launches()
    for label in C2_SHAPES:
        ring, m, k, n = c2_shape(label)
        L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
        lhs_dig, band = tp.operands(ring, m, k, n, 15, dev)
        before, relaid = launches(), tp.pass1_dot.relayouts
        res = timed(path["shapes"].setdefault(label, {}), "path_ms",
                    lambda: tp.run(lhs_dig, band, ring))
        ran = {name: c - before[name] for name, c in launches().items()}
        path["launches"] = {name: c + ran[name] for name, c in path["launches"].items()}
        relayouts = tp.pass1_dot.relayouts - relaid
        del res["A"]
        torch.cuda.empty_cache()
        plain = []
        plain_ms = cuda_ms(lambda: plain.append(fold_only_plain_by_limb(ring, res["cols"])),
                           reps=1, warmup=0)
        fold_err = max_abs_err(res["C"], plain[0])
        worst = max(worst, fold_err)
        del plain, res["C"]
        torch.cuda.empty_cache()
        path["shapes"][label].update({"CH": L * S, "m": m, "k": k, "n": n, "nd": nd,
                                      "launches": ran, "pass1_relayouts": relayouts,
                                      "c_equals_a": res["equal"], "fold_max_abs_err": fold_err})
        check(res["equal"], f"the two passes differ from kernel 1 at the {label} c2 shape")
        check(fold_err == 0, f"fold_only differs from its plain version at the {label} c2 "
                             "shape")
        check(relayouts == 0, f"pass 1 copied an operand {relayouts} times at {label}")
        probe_launches_only(ran, {fm.KERNEL: 1, BARE: 1, FOLD_ONLY_KERNEL: 1},
                            f"the two-pass path at {label}")
        t = tp.times(lhs_dig, band, ring, res["cols"])
        b = tp.bounds(ring, m, k, n)
        shape = f"c2 CH={L * S} m={m} n={n} kd={k * nd} nd={nd}"
        timing[label] = {
            "phase": "twopass_timing", "card": card, "shape": shape, **t, **b,
            "pass2_plain_ms": plain_ms, "pass2_plain": "one limb at a time",
            "x_pass2_bound": t["pass2_ms"] / b["pass2_bound_ms"],
            "x_two_pass_bound": t["C_ms"] / b["two_pass_bound_ms"],
            "c_over_a": t["C_ms"] / t["A_ms"], "verdict": tp.verdict(t["C_ms"], t["A_ms"]),
            # the kernels line's record of fold_only (pass 2)
            "fold_only": {"shape": f"{shape}: int32 columns -> residues", "ms": t["pass2_ms"],
                          "ms_spread": t["pass2_ms_spread"], "plain_ms": plain_ms,
                          "bound_ms": b["pass2_bound_ms"], "bound_by": "bytes",
                          "library_ms": None,
                          "x_bound": t["pass2_ms"] / b["pass2_bound_ms"], "x_library": None}}
        emit(timing[label])
        del lhs_dig, band, res
        torch.cuda.empty_cache()
    emit(path)
    return path, worst, timing


def phase_int32_peak(dev, card: str) -> tuple[dict, int, dict]:
    """The int32 multiply-add peak (``pvw_tpu_torch.benchmarks.
    fold_roofline``) on the JAX probe's tile (512, 1024): bit-exact against
    its plain version at its 512 multiply-adds an element (lanes 8 and 1);
    then the path, counted: the probe's measurement at 65536 and 131072
    (CUDA events, median of 5), gated on linearity (the time at twice the
    work 1.9-2.1x), with the IMAD rate, the JAX probe's count of 2 operations
    a multiply-add and ``INT32_OPS_PER_S`` beside each other; then bit-exact
    against its plain version at both timed counts too (the plain version
    timed once at 65536). Its bound is the function's multiply-adds at
    ``INT32_OPS_PER_S`` (the kernel's extra register IMAD a block is its
    own). -> (the path record, the worst difference, the timing record)."""
    from pvw_tpu_torch.benchmarks import fold_roofline as fr

    x = fr.tile(dev)
    worst = 0
    for lanes in (8, 1):
        err = max_abs_err(fr.int32_peak(x, fr.CHECK_ITERS, lanes),
                          fr.int32_peak_plain(x, fr.CHECK_ITERS, lanes))
        worst = max(worst, err)
        emit({"phase": "int32_peak_vs_plain", "kernel": INT32_PEAK_KERNEL,
              "shape": f"{tuple(x.shape)} x {fr.CHECK_ITERS} multiply-adds, lanes {lanes}",
              "bit_exact": err == 0, "max_abs_err": err})
        check(err == 0, f"int32_peak differs from its plain version at lanes {lanes}")
    reset_launches()
    r = fr.measure(x, fr.TIMED_ITERS)
    ran = launches()
    # two timings of a warm-up and 5 runs each
    probe_launches_only(ran, {INT32_PEAK_KERNEL: 12}, "the int32 peak path")
    check(1.9 <= r["linearity"] <= 2.1, f"int32_peak took {r['linearity']:.3f}x the time at "
                                        "twice the multiply-adds: not every one ran")
    plain = []
    plain_ms = cuda_ms(lambda: plain.append(fr.int32_peak_plain(x, fr.TIMED_ITERS)),
                       reps=1, warmup=0)
    for iters, want in ((fr.TIMED_ITERS, plain.pop()),
                        (2 * fr.TIMED_ITERS, fr.int32_peak_plain(x, 2 * fr.TIMED_ITERS))):
        err = max_abs_err(fr.int32_peak(x, iters), want)
        worst = max(worst, err)
        emit({"phase": "int32_peak_vs_plain", "kernel": INT32_PEAK_KERNEL,
              "shape": f"{tuple(x.shape)} x {iters} multiply-adds, lanes 8 (timed)",
              "bit_exact": err == 0, "max_abs_err": err})
        check(err == 0, f"int32_peak differs from its plain version at {iters} multiply-adds")
    imads = fr.imads(x.numel(), fr.TIMED_ITERS, 8)
    bound_ms = r["madds"] / INT32_OPS_PER_S * 1e3
    rec = ratios({"phase": "int32_peak", "kernel": INT32_PEAK_KERNEL, "card": card,
                  "shape": f"{tuple(x.shape)} x {fr.TIMED_ITERS} multiply-adds, 8 lanes", **r,
                  "imads": imads, "int32_ops_per_s": INT32_OPS_PER_S,
                  "imad_over_int32_ops": r["imad_per_s"] / INT32_OPS_PER_S,
                  "jax_ops_over_int32_ops": r["jax_ops_per_s"] / INT32_OPS_PER_S,
                  "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
                  "bound_by": "operations",
                  "bound_counts": "the function's multiply-adds at INT32_OPS_PER_S (one "
                                  "instruction a lane and clock); 8 bytes an element "
                                  "beside them"})
    emit(rec)
    return {"phase": "int32_peak_path", "card": card, "launches": ran}, worst, rec


def phase_dot_structure(dev, card: str) -> tuple[dict, int, dict]:
    """Kernel 1's contraction with the trivial epilogue
    (``pvw_tpu_torch.benchmarks.probe_dot_structure``) in its three band
    layouts at the toy and config-4 c2 shapes, the JAX probe's random
    operands in [-64, 64). Each layout's band relaid once (k innermost)
    before the counts are set to 0; ``dot_structure_path``: the three
    launches, counted (each layout once a shape, nothing else, no relayout),
    every output against the layout's plain version (one limb at a time,
    ``dot_structure_vs_plain``) and the three equal. ``dot_structure_timing``:
    each launch (CUDA events, median of 5 with the spread) beside its bound
    (the int8 operations, 1.74 / 9.45 ms), its plain version,
    ``torch._int_mm`` of the contraction (the JAX probe's one-dot floor) and
    kernel 1 bare (its fold) on the same operands, T MAC/s and the fold's
    share of kernel 1. -> (the path record, the worst difference, {layout:
    {label: timing record}})."""
    import torch

    from pvw_tpu_torch.benchmarks import C2_SHAPES, c2_shape, probe_dot_structure as ds
    from pvw_tpu_torch.ops import fused_modmat as fm

    path = {"phase": "dot_structure_path", "card": card, "shapes": {},
            "launches": dict.fromkeys(launches(), 0)}
    timing = {layout: {} for layout in ds.LAYOUTS}
    worst = 0
    reset_launches()
    for label in C2_SHAPES:
        ring, m, k, n = c2_shape(label)
        L, S, nd = ring.num_limbs, ring.degree, ring.num_digits
        ch, kd = L * S, k * nd
        lhs, band = ds.operands(ch, m, kd, nd, n, 16, dev)
        relaid = ds.dot_structure.relayouts
        laid = {}
        for layout in ds.LAYOUTS:
            laid[layout] = ds.dot_operand(ds.band_layout(band, layout), layout)
            torch.cuda.empty_cache()
        layout_relayouts = ds.dot_structure.relayouts - relaid
        before, relaid = launches(), ds.dot_structure.relayouts
        outs = {layout: ds.dot_structure(lhs, laid[layout], layout, ds.TN, nd)
                for layout in ds.LAYOUTS}
        torch.cuda.synchronize()
        ran = {name: c - before[name] for name, c in launches().items()}
        path["launches"] = {name: c + ran[name] for name, c in path["launches"].items()}
        probe_launches_only(ran, {dot_name(layout): 1 for layout in ds.LAYOUTS},
                            f"the dot-structure path at {label}")
        check(ds.dot_structure.relayouts == relaid,
              f"the dot-structure launches relaid an operand at {label}")
        shape = f"c2 CH={ch} m={m} kd={kd} nd={nd} D={n}"
        plain_ms = {}
        for layout in ds.LAYOUTS:
            def plain(layout=layout):
                return torch.cat([ds.dot_structure_plain(lhs[i * S:(i + 1) * S],
                                                         laid[layout][i * S:(i + 1) * S],
                                                         layout, ds.TN, nd)
                                  for i in range(L)])

            want = []
            plain_ms[layout] = cuda_ms(lambda: want.append(plain()), reps=1, warmup=0)
            err = max_abs_err(outs[layout], want[0])
            worst = max(worst, err)
            emit({"phase": "dot_structure_vs_plain", "kernel": dot_name(layout),
                  "shape": shape, "compared": "every output, one limb at a time",
                  "bit_exact": err == 0, "max_abs_err": err})
            check(err == 0, f"dot_structure ({layout}) differs from its plain version at "
                            f"{label}")
            del want
            torch.cuda.empty_cache()
        same = all(torch.equal(outs[layout], outs["planes"]) for layout in ds.LAYOUTS)
        check(same, f"the three layouts differ from each other at {label}")
        path["shapes"][label] = {"shape": shape, "launches": ran,
                                 "layout_relayouts": layout_relayouts, "layouts_equal": same}
        del outs
        torch.cuda.empty_cache()
        macs = ch * m * kd * nd * n
        library = kernel_times(lambda: ds.int_mm(lhs, band), reps=3)
        torch.cuda.empty_cache()
        k1 = kernel_times(lambda: fm.matmul_fold_scaled(
            None, band.reshape(L, S, nd, kd, n), ring, lhs_dig=lhs.reshape(L, S, m, kd)))
        nbytes = lhs.numel() + band.numel() + 4 * ch * m * n
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * macs / INT8_OPS_PER_S * 1e3
        for layout in ds.LAYOUTS:
            t = kernel_times(lambda: ds.dot_structure(lhs, laid[layout], layout, ds.TN, nd))
            timing[layout][label] = ratios({
                "phase": "dot_structure_timing", "kernel": dot_name(layout), "card": card,
                "shape": shape, **t, "plain_ms": plain_ms[layout],
                "plain": "one limb at a time", "library_ms": library["ms"],
                "library": "torch._int_mm of the contraction, one channel at a time (the "
                           "int32 products, no combine)",
                "library_ms_spread": library["ms_spread"],
                "kernel1_bare_ms": k1["ms"], "kernel1_bare_ms_spread": k1["ms_spread"],
                "fold_share_of_kernel1": (k1["ms"] - t["ms"]) / k1["ms"],
                "t_mac_per_s": macs / t["ms"] / 1e9, "int8_macs": macs,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                "bytes": nbytes, "bytes_ms": bytes_ms, "ops_ms": ops_ms})
            emit(timing[layout][label])
        del lhs, band, laid
        torch.cuda.empty_cache()
    emit(path)
    return path, worst, timing


# --------------------------------------------------------------------------
# the party's side: one key at a time, the bytes, the decode engines
# --------------------------------------------------------------------------

# the parties that re-make their keys one at a time on party_path
PARTY_REGEN = (0, 1, REF_N // 2 - 1, REF_N - 1)
# the decryption batches below the crossover on party_path: the first 16
# dealers, and a threshold subset of 32 (every 32nd dealer) at ceil(2*32/3)
SMALL_BATCH = 16
SUBSET = 32
# the batch sizes of the crossover timing: the reference preset (n = 1024)
# and the toy chain (n = 4096)
CROSSOVER_D = (1, 4, 16, 32, 64, 128, 256, 512, 1024)
CROSSOVER_D_TOY = CROSSOVER_D + (2048, 4096)
INTEROP_NK = 8


def dealer_ciphertexts(ct) -> list:
    """The d unbatched ciphertexts of a batched one (c1 [k, d], c2 [n, d]),
    views of its canonical residues."""
    import pvw_tpu_torch as P

    ring, c1, c2 = ct.params.ring, ct.c1.res, ct.c2.res
    return [P.PvwCiphertext(P.Poly(c1[:, j], ct.c1.rep, ring), P.Poly(c2[:, j], ct.c2.rep, ring),
                            ct.params) for j in range(c1.shape[1])]


def round_trip(times: dict, sizes: dict, same: dict, name: str, objs: list, load) -> list:
    """Each of ``objs`` to bytes, loaded back by ``load(blob)`` and to bytes
    again: the summed host-clocked ms of each step and the MB under
    ``name``; ``same[name]`` whether every second blob equals its first."""
    blobs = timed(times, f"{name}_to_bytes_ms", lambda: [o.to_bytes() for o in objs])
    loaded = timed(times, f"{name}_from_bytes_ms", lambda: [load(b) for b in blobs])
    again = timed(times, f"{name}_re_to_bytes_ms", lambda: [o.to_bytes() for o in loaded])
    sizes[f"{name}_mb"] = sum(len(b) for b in blobs) / 1e6
    same[name] = again == blobs
    return loaded


def phase_party_path(dev, card: str, seed: int) -> tuple[dict, dict]:
    """The party's side at the reference preset (``secure_128_reference``,
    n = k = 1024, l = 8, 4 x 55-bit limbs, v3k), through the entry points:
    CRS and batch keygen of every party, the encryption operands cached,
    then the parties of ``PARTY_REGEN`` re-make their keys one at a time
    (``generate_and_add_with_errors``: each row exactly sᵀA + its recorded
    errors, ``get_public_key`` returning it); 1024 dealers encrypted after
    the change (kernels 4, 1 and the v3k generator), every share of parties
    0 and n-1 exact; params, CRS, the global key with its errors, the four
    parties' public and secret keys and every dealer's ciphertext to bytes,
    loaded back on the card and to bytes again (identical), the loaded
    global key encrypting the same ciphertexts (so the operand cache was
    remade); then party 0 decrypts the loaded ciphertexts: 16 dealers and a
    threshold subset of 32 under ``auto`` (the host engine, no device
    decode), one message, every dealer under ``auto`` (the device decode)
    and ``native`` (the C++ decode), each equal to the Python decode and the
    shares; and a small ``pvw-vectors-v1`` case (n = k = 8) dumped and
    loaded on the card. The launch counts over the path and each stage."""
    import torch

    import pvw_tpu_torch as P
    from pvw_tpu_torch import interop, random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.params import presets

    params = presets.secure_128_reference(REF_N)
    n, k, l = params.n, params.k, params.l
    key = R.key(seed)
    rng = np.random.default_rng(seed)
    shares = rng.integers(0, 1 << 32, size=(n, n), dtype=np.uint64)
    times, sizes, same, stage_launches, engines = {}, {}, {}, {}, {}

    def counted(name: str, fn):
        """``fn()``, timed, with the counts that rose in it."""
        before = launches()
        out = timed(times, f"{name}_ms", fn)
        stage_launches[name] = {c: v - before[c] for c, v in launches().items()
                                if v != before[c]}
        return out

    def decrypted(name: str, fn, mode: str = "auto"):
        """``fn()`` under decode ``mode``, timed, with the engines it ran."""
        settings.decode_mode = mode
        try:
            out = counted(name, fn)
        finally:
            del settings.decode_mode
        engines[name] = {c: stage_launches[name].get(c, 0) for c in
                         (HOST_DECRYPTS, DECODES, NATIVE_DECODES, PYTHON_DECODES)}
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    settings.noise_stream = "v3k"
    try:
        reset_launches()
        crs = timed(times, "crs_ms", lambda: P.PvwCrs.new(params, R.fold_in(key, 0),
                                                          device=dev))
        coeffs = P.sample_vec_cbd(R.fold_in(key, 10_000), (n, k, l), params.secret_variance,
                                  device=dev)
        gpk = P.GlobalPublicKey(crs)
        counted("keygen", lambda: gpk.generate_all_keys_device(coeffs, R.fold_in(key, 1)))
        host_coeffs = coeffs.cpu().numpy()
        del coeffs
        planes_before = timed(times, "operands_ms", gpk.encrypt_operands)
        sks = {i: P.SecretKey(params, host_coeffs[i]) for i in PARTY_REGEN}
        batch_rows = gpk.matrix.res[list(PARTY_REGEN)].clone()
        for i in PARTY_REGEN:
            counted(f"keygen_party_{i}", lambda: gpk.generate_and_add_with_errors(
                i, sks[i], R.fold_in(key, 20 + i)))
        rows_exact = all(
            torch.equal(gpk.matrix.res[i], (crs.multiply_by_secret_key(sks[i])
                                            + gpk.get_party_errors(i)).res)
            and torch.equal(gpk.get_public_key(i).key_polynomials.res, gpk.matrix.res[i])
            for i in PARTY_REGEN)
        rows_changed = not any(torch.equal(gpk.matrix.res[i], batch_rows[r])
                               for r, i in enumerate(PARTY_REGEN))
        ct = counted("encrypt", lambda: P.encrypt_all_party_shares_batched(
            shares, gpk, R.fold_in(key, 777)))
        operands_remade = gpk.encrypt_operands()[1] is not planes_before[1]
        del planes_before
        full = {i: decrypted(f"decrypt_party_{i}", lambda: P.decrypt_party_shares(ct, sks[i], i))
                for i in (0, n - 1)}
        # the bytes
        dev_load = {"device": dev}
        lparams = round_trip(times, sizes, same, "params", [params], P.PvwParameters.from_bytes)
        round_trip(times, sizes, same, "crs", [crs], lambda b: P.PvwCrs.from_bytes(b, **dev_load))
        (lgpk,) = round_trip(times, sizes, same, "global_public_key", [gpk],
                             lambda b: P.GlobalPublicKey.from_bytes(b, **dev_load))
        round_trip(times, sizes, same, "public_keys", [gpk.get_public_key(i) for i in PARTY_REGEN],
                   lambda b: P.PublicKey.from_bytes(b, **dev_load))
        lsks = round_trip(times, sizes, same, "secret_keys", list(sks.values()),
                          P.SecretKey.from_bytes)
        dealers = dealer_ciphertexts(ct)
        lcts = round_trip(times, sizes, same, "ciphertexts", dealers,
                          lambda b: P.PvwCiphertext.from_bytes(b, **dev_load))
        ct2 = counted("encrypt_loaded_key", lambda: P.encrypt_all_party_shares_batched(
            shares, lgpk, R.fold_in(key, 777)))
        loaded_key_same = (torch.equal(ct2.c1.channel(), ct.c1.channel())
                           and torch.equal(ct2.c2.channel(), ct.c2.channel())
                           and all(dealer_ciphertexts(ct2)[j].to_bytes() == dealers[j].to_bytes()
                                   for j in (0, n // 2, n - 1)))
        del ct2, lgpk, dealers
        # party 0 decrypts the loaded ciphertexts
        sk0 = lsks[0]
        want = [int(v) for v in shares[:, 0]]
        subset = list(range(0, n, n // SUBSET))
        got = {
            "small": decrypted("decrypt_small_auto", lambda: P.decrypt_valid_shares(
                lcts, range(SMALL_BATCH), SMALL_BATCH, sk0, 0)),
            "subset": decrypted("decrypt_subset_auto", lambda: P.decrypt_valid_shares(
                lcts, subset, -(-2 * SUBSET // 3), sk0, 0)),
            "value": decrypted("decrypt_value_auto",
                               lambda: P.decrypt_party_value(lcts[5], sk0, 0)),
            "all_auto": decrypted("decrypt_all_auto", lambda: P.decrypt_party_shares(
                lcts, sk0, 0)),
            "all_native": decrypted("decrypt_all_native", lambda: P.decrypt_party_shares(
                lcts, sk0, 0), "native"),
        }
        counts = launches()
        python = decrypted("decrypt_all_python", lambda: P.decrypt_party_shares(lcts, sk0, 0),
                           "python")
        del lcts
        # a small pvw-vectors-v1 case on the card
        small = (P.PvwParametersBuilder().set_parties(INTEROP_NK).set_dimension(INTEROP_NK)
                 .set_l(8).set_moduli(MODULI).set_secret_variance(0.5)
                 .set_error_bounds_u32(*P.PvwParameters.suggest_error_bounds(
                     INTEROP_NK, INTEROP_NK, 8, MODULI, 0.5)).build())
        scrs = P.PvwCrs.new(small, R.fold_in(key, 30), device=dev)
        sparties = [P.Party.new(i, small, R.fold_in(key, 40 + i), device=dev)
                    for i in range(small.n)]
        sgpk = P.GlobalPublicKey(scrs)
        sgpk.generate_all_party_keys(sparties, R.fold_in(key, 31))
        msgs = [int(v) for v in rng.integers(0, 1 << 32, small.n)]
        sct = P.encrypt(msgs, sgpk, R.fold_in(key, 32))
        case = timed(times, "interop_dump_ms", lambda: json.dumps(interop.dump_case(
            small, crs=scrs, secret_keys=[p.secret_key for p in sparties], ciphertext=sct,
            scalars=msgs, plaintexts=msgs)))
        loaded = timed(times, "interop_load_ms",
                       lambda: interop.load_case(json.loads(case), device=dev))
        interop_ok = (torch.equal(loaded.crs.matrix.res, scrs.matrix.res)
                      and loaded.params == small and loaded.plaintexts == msgs
                      and [P.decrypt_party_value(loaded.ciphertext, s, i)
                           for i, s in enumerate(loaded.secret_keys)] == msgs)
        sizes["interop_case_mb"] = len(case) / 1e6
    finally:
        del settings.noise_stream
    shares_exact = all(full[i] == [int(v) for v in shares[:, i]] for i in full)
    messages_exact = (all(got[name] == want for name in ("all_auto", "all_native"))
                      and python == want and got["value"] == int(shares[5, 0])
                      and got["small"] == [(j, want[j]) for j in range(SMALL_BATCH)]
                      and got["subset"] == [(j, want[j]) for j in subset])
    out = {"phase": "party_path", "card": card, "preset": "secure_128_reference",
           "config": "the reference's 128-bit example (examples/pvw_valid_dec.py:40-48)",
           "stream": "v3k", "n": n, "k": k, "l": l, "limbs": params.ring.num_limbs,
           "regenerated_parties": list(PARTY_REGEN), "rows_exact": rows_exact,
           "rows_changed": rows_changed, "operands_remade": operands_remade,
           "shares_exact": shares_exact, "bytes_identical": same,
           "loaded_key_encrypts_same": loaded_key_same, "params_equal": lparams[0] == params,
           "messages_exact": messages_exact, "engines": engines, "interop_ok": interop_ok,
           **times, **sizes, "launches": counts, "stage_launches": stage_launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit(out)
    check(rows_exact, "party_path: a re-made row is not sᵀA + its recorded errors, or "
                      "get_public_key does not return it")
    check(rows_changed, "party_path: a re-made row equals its batch keygen row")
    check(operands_remade, "party_path: the encryption operands were not remade after the "
                           "rows changed")
    check(shares_exact, "party_path: a decrypted share differs from the encrypted one")
    check(all(same.values()), f"party_path: bytes changed on a round trip: {same}")
    check(lparams[0] == params, "party_path: the loaded parameters differ")
    check(loaded_key_same, "party_path: the loaded global key encrypts other ciphertexts")
    check(messages_exact, "party_path: a decrypted message differs from the shares or the "
                          "Python decode")
    check(interop_ok, "party_path: the pvw-vectors-v1 case did not round-trip on the card")
    expect = {"decrypt_small_auto": HOST_DECRYPTS, "decrypt_subset_auto": HOST_DECRYPTS,
              "decrypt_value_auto": HOST_DECRYPTS, "decrypt_all_auto": DECODES,
              "decrypt_all_native": NATIVE_DECODES, "decrypt_all_python": PYTHON_DECODES,
              "decrypt_party_0": DECODES, f"decrypt_party_{n - 1}": DECODES}
    for name, engine in expect.items():
        check(engines[name] == {c: int(c == engine) for c in engines[name]},
              f"party_path: {name} ran {engines[name]}, not {engine} alone")
    keygen, enc = stage_launches["keygen"], stage_launches["encrypt"]
    check(keygen.get(fm.KERNEL, 0) >= 1, "party_path: kernel 1 never ran in the batch keygen")
    check(enc.get(fm.KERNEL, 0) >= 2 and enc.get(fm.PRESCALE_KERNEL, 0) >= 1
          and enc.get(fm.NOISE_KERNEL, 0) >= 1,
          f"party_path: the encryption's kernels did not all run: {enc}")
    check(counts[RELAYOUTS] == 0 and counts[ROW_RELAYOUTS] == 0,
          "party_path: an operand was relaid")
    for name in probe_kernels():
        check(counts[name] == 0, f"the probe kernel {name} launched on party_path")
    return out, {"params": params, "ct": ct, "sk": sks[0], "party": 0}


def phase_crossover(dev, card: str, configs: dict) -> dict:
    """One party's decryption of its first d dealers (``decrypt_valid_shares``)
    on the device route (the contraction and the decode on the card) and
    on the host route (the C++ engine) at each d of each of ``configs``
    (label -> (params, batched ciphertext, secret key, party, ds)): a
    warm-up of each, then three rounds, the routes' order alternating and
    every d in each, each call on the host clock (its messages fetched) and
    the device route also between two CUDA events; medians, every message
    of the two routes equal. The measured crossover is the smallest d at
    which the device route's median is below the host route's."""
    import torch

    import pvw_tpu_torch as P
    from pvw_tpu_torch.config import settings

    out = {}
    for label, (params, ct, sk, party, ds) in configs.items():
        def run(mode, d):
            settings.decode_mode = mode
            try:
                return P.decrypt_valid_shares(ct, range(d), d, sk, party)
            finally:
                del settings.decode_mode

        runs = {(m, d): [] for m in ("device", "host") for d in ds}
        events = {d: [] for d in ds}
        equal = all(run("device", d) == run("host", d) for d in ds)
        for r in range(3):
            for d in ds:
                for mode in (("device", "host") if r % 2 == 0 else ("host", "device")):
                    t, start, end = {}, torch.cuda.Event(True), torch.cuda.Event(True)
                    start.record()
                    timed(t, "ms", lambda: run(mode, d))
                    end.record()
                    end.synchronize()
                    runs[(mode, d)].append(t["ms"])
                    if mode == "device":
                        events[d].append(start.elapsed_time(end))
        med = {f"{m}_ms": {str(d): statistics.median(runs[(m, d)]) for d in ds}
               for m in ("device", "host")}
        faster = [d for d in ds if med["device_ms"][str(d)] < med["host_ms"][str(d)]]
        rec = {"phase": "crossover", "config": label, "card": card, "party": party,
               "limbs": params.ring.num_limbs, "k": params.k, "ds": list(ds), **med,
               "device_event_ms": {str(d): statistics.median(v) for d, v in events.items()},
               "runs": {f"{m}_{d}": v for (m, d), v in runs.items()},
               "routes_equal": equal, "measured_crossover": faster[0] if faster else None,
               "default_crossover": settings.decode_crossover}
        out[label] = rec
        emit(rec)
        check(equal, f"crossover: the host and device routes decrypt differently at {label}")
    return out


# --------------------------------------------------------------------------
# the mesh across processes, forced digit widths and the examples
# --------------------------------------------------------------------------

# the mesh across processes: 4 ranks x 1 device on the (2, 2) mesh
MULTIPROC_WORLD, MULTIPROC_LOCAL = 4, 1
# the ref128-n8192-mesh4 cell's parties (and dealers): BASELINE config 5
MESH_N = 8192
# the twins' blocks in mesh_kernels_vs_plain: dealer columns, residue-noise rows
MESH_TWIN_COLS, MESH_TWIN_ROWS = 1024, 256
FORCED_WIDTHS = (6, 7, 8)
EXAMPLES = ("pvw", "pvw_valid_dec", "pvw_sharded", "interop_exchange")
# runs one example in a fresh interpreter, its launches counted from 0
EXAMPLE_RUNNER = (
    "import json, runpy, sys\n"
    "import chip_smoke\n"
    "name = sys.argv[1]\n"
    "sys.argv = [name]\n"
    "chip_smoke.reset_launches()\n"
    "runpy.run_module('pvw_tpu_torch.examples.' + name, run_name='__main__')\n"
    "print(json.dumps({'example_launches': chip_smoke.launches()}))\n")


def mesh_kernels_vs_plain(params, dev) -> dict:
    """The kernels of a (2, 2) mesh's shards at ``params`` (d = n dealers,
    v3k) against their twins at the shapes the shards give them, every
    output byte: kernel 4 at a shard's r (its kdim block of k/2 rows x d,
    the CBD bound), the generator's masked planes and kernel 1's masked
    form (6-word seeds, c1's bound) at a recv-row-0 c1 shard (k rows, kdim
    block k/2, d columns) on each kdim block's rows and on rows straddling
    both, kernel 1 bare at a c2 shard of the bake route (n/2 rows, kdim
    block k/2, d columns) and the residue-noise generator at the bake
    route's block (n/4 rows at the last block's row offset 3n/4, d columns,
    c2's bound). Each kernel's output is made whole; its twin runs on
    :data:`MESH_TWIN_COLS` dealer columns at a time (the residue noise's on
    :data:`MESH_TWIN_ROWS` rows), so that it fits beside it at n = 8192.
    Random operands from a seed. -> the worst difference by kernel."""
    import torch

    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.ops.ntt import signed_digit_count
    from pvw_tpu_torch.sampling.cbd import cbd_bound

    ring, k, n, l = params.ring, params.k, params.n, params.l
    d, kc, nl, b1, b2 = n, k // 2, n // 2, params.error_bound_1, params.error_bound_2
    gen = torch.Generator(device=dev).manual_seed(15)
    worst = {fm.PRESCALE_KERNEL: 0, fm.NOISE_KERNEL: 0, fm.MASKED_KERNEL: 0, BARE: 0,
             fm.RESIDUE_NOISE_KERNEL: 0}

    def by_columns(got, twin):
        """(got's dealer columns [c0, c1), twin(c0, c1)), block by block."""
        return ((got[..., c0:c0 + MESH_TWIN_COLS], twin(c0, c0 + MESH_TWIN_COLS))
                for c0 in range(0, got.shape[-1], MESH_TWIN_COLS))

    def held(kernel: str, shape: str, pairs) -> None:
        err = max(max_abs_err(got, want) for got, want in pairs)
        emit({"phase": "multiprocess_vs_plain", "kernel": kernel, "shape": shape,
              "nd": ring.num_digits, "compared": "every output", "bit_exact": err == 0,
              "max_abs_err": err})
        check(err == 0, f"{kernel} differs from its twin at the mesh's {shape}")
        worst[kernel] = max(worst[kernel], err)

    bound = cbd_bound(params.secret_variance)
    c = r_coeffs(kc, d, l, bound, gen, dev)
    held(fm.PRESCALE_KERNEL, f"r k={kc} d={d}", by_columns(
        fm.ntt_prescale_band(c, ring, bound),
        lambda c0, c1: fm.ntt_prescale_band_plain(c[:, c0:c1], ring, bound)))
    del c
    lhs_dig, band, *_ = operands(ring, k, kc, d, 1, None, gen, dev)
    for lo, hi in ((0, kc), (kc, k), (k // 4, 3 * k // 4)):
        rows = f"c1 m={k} kc={kc} n={d}, rows [{lo}, {hi})"
        planes = fm.v3k_noise_planes_plain(*V3K_KEY, 0, k, d, l, b1, 0, dev, mask=(lo, hi))
        held(fm.NOISE_KERNEL, rows,
             [(fm.v3k_noise_planes(*V3K_KEY, 0, k, d, l, b1, 0, dev, mask=(lo, hi)), planes)])
        g = ((*V3K_KEY, 0, lo, hi, 0), signed_digit_count(b1), b1, "tfry")
        held(fm.MASKED_KERNEL, rows, by_columns(
            fm.matmul_fold_scaled(None, band, ring, lhs_dig=lhs_dig, gen_noise=g,
                                  noise_bound=b1),
            lambda c0, c1: fold_plain_by_limb(ring, band[..., c0:c1], lhs_dig,
                                              planes[..., c0:c1], mask=(0, lo, hi))))
        del planes
    del lhs_dig, band
    lhs_dig, band, *_ = operands(ring, nl, kc, d, 1, None, gen, dev)
    held(BARE, f"c2 m={nl} kc={kc} n={d}", by_columns(
        fm.matmul_fold_scaled(None, band, ring, lhs_dig=lhs_dig),
        lambda c0, c1: fold_plain_by_limb(ring, band[..., c0:c1], lhs_dig)))
    del lhs_dig, band
    torch.cuda.empty_cache()
    kk, blk, row_off = R.fold_in(R.key(15), 2), nl // 2, 3 * n // 4
    got = fm.residue_noise_ch(kk, row_off, blk, d, b2, ring, dev)
    held(fm.RESIDUE_NOISE_KERNEL, f"c2 bake block rows={blk} at {row_off} cols={d}",
         ((got[:, :, r0:r0 + MESH_TWIN_ROWS], fm.residue_noise_ch_plain(
             kk, row_off + r0, min(MESH_TWIN_ROWS, blk - r0), d, b2, ring, dev))
          for r0 in range(0, blk, MESH_TWIN_ROWS)))
    del got
    torch.cuda.empty_cache()
    return worst


def phase_multiprocess(card: str, devices=None) -> tuple[dict, dict]:
    """``parallel.multiprocess`` at the reference preset
    (``secure_128_reference(REF_N)``): 4 ranks x 1 device, the (2, 2) mesh,
    so that the kdim gather crosses processes, REF_N dealers under v3k,
    spawned as fresh interpreters on the kernels and engine this process
    built (gloo on one card, NCCL on a card a rank). Each rank checks c1
    and its owned c2 rows against its own single-device encryption byte for
    byte and decodes its owned dealers exactly (the launcher raises
    otherwise). Gates, per rank: kernel 4 and kernel 1 bare (c2's bake
    route); on recv row 0, kernel 1 masked and the v3k generator (c1); one
    device decode on each recv row's head. First, the shards' kernels
    against their twins (:func:`mesh_kernels_vs_plain`, at this system and
    at the ``ref128-n8192-mesh4`` cell's, n = :data:`MESH_N`) and, for
    comparison, the same system's in-process (2, 2) mesh over ``devices``
    (default ``cuda:0`` four times), ``torch.equal`` to the single-device
    encryption. Returns the path's launches, summed over ranks, and the
    kernels' worst differences from their twins."""
    import torch

    from pvw_tpu_torch import encrypt_batch
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.parallel import encrypt_batch_sharded, make_mesh
    from pvw_tpu_torch.parallel import multiprocess as mp
    from pvw_tpu_torch.params import presets

    devices = devices or [torch.device("cuda", 0)] * MULTIPROC_WORLD
    dev = devices[0]
    params = presets.secure_128_reference(REF_N)
    worst = mesh_kernels_vs_plain(params, dev)
    for name, err in mesh_kernels_vs_plain(presets.secure_128_reference(MESH_N), dev).items():
        worst[name] = max(worst[name], err)
    times = {}
    gpk, _, vectors, enc_key = timed(times, "system_ms",
                                     lambda: mp.build_system(params, REF_N, dev))
    mesh = make_mesh(devices, kdim=2)
    settings.noise_stream = "v3k"
    try:
        single = timed(times, "single_device_ms", lambda: encrypt_batch(vectors, gpk, enc_key))
        encrypt_batch_sharded(vectors, gpk, enc_key, mesh)
        inproc = timed(times, "in_process_mesh_ms",
                       lambda: encrypt_batch_sharded(vectors, gpk, enc_key, mesh))
    finally:
        del settings.noise_stream
    same = (torch.equal(inproc.c1.channel(), single.c1.channel())
            and torch.equal(inproc.c2.channel(), single.c2.channel()))
    check(same, "the in-process (2, 2) mesh differs from the single-device encryption")
    del gpk, single, inproc
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = mp.dryrun_multiprocess(MULTIPROC_WORLD, MULTIPROC_LOCAL, timeout_s=600, attempts=2,
                                 device="cuda", params=params, dealers=REF_N, stream="v3k")
    wall_ms = (time.perf_counter() - t0) * 1e3
    ranks = out.ranks
    check(len(ranks) == MULTIPROC_WORLD, f"{len(ranks)} ranks reported of {MULTIPROC_WORLD}")
    total = {name: 0 for name in launches()}
    for r in ranks:
        ran = r["launches"]
        head = r["msgs_checked"] > 0
        check(ran[fm.PRESCALE_KERNEL] > 0, f"rank {r['rank']}: kernel 4 never ran")
        check(ran[fm.KERNEL] > 0 and ran[BARE] > 0, f"rank {r['rank']}: kernel 1 bare never ran")
        if any(row == 0 for row, _ in r["shards"]):
            check(ran[fm.MASKED_KERNEL] > 0 and ran[fm.NOISE_KERNEL] > 0,
                  f"rank {r['rank']} (recv row 0): kernel 1 masked or the generator never ran")
        check(r["decodes"] == (1 if head else 0),
              f"rank {r['rank']}: {r['decodes']} device decodes")
        check(ran[DECODE_KERNEL] == r["decodes"],
              f"rank {r['rank']}: the decode kernel launched {ran[DECODE_KERNEL]} times for "
              f"{r['decodes']} device decodes")
        for name, count in ran.items():
            total[name] += count
        total[DECODES] += r["decodes"]
    check(sum(r["msgs_checked"] for r in ranks) == ranks[0]["dealers"],
          "not every dealer was decoded by its recv row's head")
    check(any(r["cross_process_rows"] for r in ranks), "no kdim gather crossed processes")
    # the ranks start their products together (a barrier): the encryption
    # ends with the slowest rank's gather
    encrypt_ms = max(r["times_ms"]["sharded_products_ms"] + r["times_ms"]["gather_modsum_ms"]
                     for r in ranks)
    emit({"phase": "multiprocess_path", "card": card, "summary": out.summary,
          "preset": "secure_128_reference", "world": MULTIPROC_WORLD,
          "local_devices": MULTIPROC_LOCAL, "mesh": ranks[0]["mesh"],
          "backend": ranks[0]["backend"], "transport": ranks[0]["transport"],
          "stream": ranks[0]["stream"], "dealers": ranks[0]["dealers"], "wall_ms": wall_ms,
          "encrypt_ms": encrypt_ms, "in_process_devices": [str(d) for d in devices], **times,
          "ranks": [{k: r[k] for k in ("rank", "device", "shards", "cross_process_rows",
                                       "rows_checked", "msgs_checked", "launches", "decodes",
                                       "times_ms", "peak_gb")} for r in ranks],
          "max_abs_err": worst, "launches": total})
    return {"launches": total}, worst


def mesh_service_inputs(view) -> dict:
    """The inputs of :func:`phase_mesh_service`'s ranks
    (``MeshService``'s input function, loaded by path on every rank): its
    recv rows' secret coefficients in the CBD range and one slot of uniform
    u64 scalars, drawn on the rank from the seed and the row."""
    import torch

    from pvw_tpu_torch.sampling.cbd import cbd_bound

    p, seed = view.params, view.args["seed"]
    bound = cbd_bound(p.secret_variance)
    coeffs, slot = {}, {}
    for r, (lo, hi) in view.rows.items():
        gen = torch.Generator(device=view.device).manual_seed(seed + r)
        coeffs[r] = torch.randint(-bound, bound + 1, (hi - lo, p.k, p.l), generator=gen,
                                  device=view.device, dtype=torch.int32)
        slot[r] = np.random.default_rng([seed, r]).integers(
            0, 2**64 - 1, size=(p.n, hi - lo), dtype=np.uint64, endpoint=True)
    return {"coeffs": coeffs, "pool": [slot]}


def phase_mesh_service(card: str) -> dict | None:
    """The served (2, 2) mesh (``parallel.multiprocess.MeshService``) at
    the ``ref128-n8192-mesh4`` cell's configuration:
    ``secure_128_reference(MESH_N)`` under v3k, n dealers a round, 4 ranks a
    card each over NCCL (this process rank 0 on ``cuda:0``), each holding
    its recv row's keys alone (:func:`mesh_service_inputs`). One warm round,
    every rank's launch counts set to 0, one round, the counts read. Gates,
    per rank: kernel 4; kernel 1 bare and the residue-noise generator (c2's
    bake route on every shard); kernel 1 masked and the v3k generator on
    recv row 0 and neither on recv row 1; no other kernel. Needs
    :data:`MULTIPROC_WORLD` cards: with fewer it emits a skip and returns
    None, else the launches summed over ranks."""
    from pathlib import Path

    import torch

    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm
    from pvw_tpu_torch.parallel import multiprocess as mp
    from pvw_tpu_torch.params import presets

    cards = torch.cuda.device_count()
    if cards < MULTIPROC_WORLD:
        emit({"phase": "mesh_service_path", "card": card,
              "skipped": f"needs {MULTIPROC_WORLD} cards, {cards} visible"})
        return None
    params, seed = presets.secure_128_reference(MESH_N), 21
    key = R.key(seed)
    times = {}
    t0 = time.perf_counter()
    settings.noise_stream = "v3k"
    try:
        svc = mp.MeshService(params, R.fold_in(key, 1), R.fold_in(key, 2),
                             f"{Path(__file__).resolve()}:mesh_service_inputs", {"seed": seed},
                             world=MULTIPROC_WORLD, device="cuda",
                             settings={"noise_stream": "v3k"})
        try:
            times["setup_ms"] = (time.perf_counter() - t0) * 1e3
            timed(times, "warm_round_ms", lambda: svc.round(0, 0, R.fold_in(key, 3)))
            svc.launches(reset=True)
            timed(times, "round_ms", lambda: svc.round(1, 0, R.fold_in(key, 4)))
            ranks = svc.launches()
            layout = svc.layout
            peak_gb = torch.cuda.max_memory_allocated(0) / 1e9
        finally:
            svc.close()
    finally:
        del settings.noise_stream
    check(svc.backend == "nccl", f"the served mesh ran over {svc.backend}")
    expected = {fm.KERNEL, fm.PRESCALE_KERNEL, BARE, fm.RESIDUE_NOISE_KERNEL}
    row0 = {fm.MASKED_KERNEL, fm.NOISE_KERNEL}
    total = {name: 0 for name in launches()}
    for rank, ran in enumerate(ranks):
        on_row0 = any(r == 0 for r, _ in layout.shards(rank))
        for name, count in ran.items():
            want = name in expected or (on_row0 and name in row0)
            check(count > 0 if want else count == 0,
                  f"rank {rank} (recv row {layout.shards(rank)[0][0]}): {name} launched "
                  f"{count} times in a served round")
            total[name] += count
    emit({"phase": "mesh_service_path", "card": card, "preset": "secure_128_reference",
          "n": params.n, "k": params.k, "dealers": params.n, "world": MULTIPROC_WORLD,
          "mesh": [layout.recv, layout.kdim], "backend": svc.backend, "stream": "v3k", **times,
          "rank0_peak_gb": peak_gb, "rank_launches": ranks, "launches": total})
    return {"launches": total}


def phase_num_digits(dev, card: str, ctx) -> tuple[dict, dict]:
    """The toy chain under v3k (``ctx`` of ``v3k_path``: its parameters,
    keys, shares and party 0's secret key) with ``settings.num_digits``
    forced to 6, 7 and 8 on a freshly built ring: at each width kernel 4,
    the v3k generator and kernel 1 (with ``gen_noise`` and the encode, and
    at the full c2 shape with noise planes) against their twins, every
    byte, kernel 1 timed (nd = 5 too, in the same run), then n dealers
    encrypted on the width's ring (the keys carried over as residues),
    byte for byte the nd = 5 ciphertext, and party 0's shares decrypted.
    The path's launches (the encryptions and decryptions, nd = 5's
    included) are counted; the comparisons' are not."""
    import torch

    import pvw_tpu_torch as P
    from pvw_tpu_torch import convert, random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import fused_modmat as fm, tfry
    from pvw_tpu_torch.ops.ntt import signed_digit_count
    from pvw_tpu_torch.params import presets
    from pvw_tpu_torch.params.ring import get_ring

    params, gpk, shares, sk = ctx["params"], ctx["gpk"], ctx["shares"], ctx["sk"]
    n = params.n
    key = R.key(14)
    total = {name: 0 for name in launches()}
    widths, timing = {}, {}
    masked_worst = 0

    def path(g, s) -> tuple:
        """n dealers under v3k on the key ``g`` (its ring's width) and party
        0's decryption with ``s``, the launches added to ``total``."""
        before = launches()
        settings.noise_stream = "v3k"
        try:
            ct = P.encrypt_all_party_shares_batched(shares, g, key)
            got = P.decrypt_party_shares(ct, s, 0)
        finally:
            del settings.noise_stream
        torch.cuda.synchronize()
        ran = {k: c - before[k] for k, c in launches().items()}
        for k, c in ran.items():
            total[k] += c
        return ct, got == [int(v) for v in shares[:, 0]], ran

    base, ok, _ = path(gpk, sk)
    check(ok, "party 0's shares at nd = 5")
    base_c1, base_c2 = base.c1.channel(), base.c2.channel()
    crs_res, gpk_res = gpk.crs.matrix.residues_np(), gpk.matrix.residues_np()
    timing[5] = phase_timing(params.ring, N_RECEIVERS, K_DIM, dev, card, "num_digits_timing")
    gen = torch.Generator(device=dev).manual_seed(14)
    try:
        for nd in FORCED_WIDTHS:
            settings.num_digits = nd
            get_ring.cache_clear()
            pf = presets.pvss_8192(n)
            ring = pf.ring
            check(ring.num_digits == nd, f"the ring was built at nd = {ring.num_digits}, not {nd}")
            worst = 0
            # kernel 4 at the path's r shape (k x n dealers, the CBD bound)
            c = r_coeffs(K_DIM, n, ELL, 1, gen, dev)
            worst = max(worst, max_abs_err(fm.ntt_prescale_band(c, ring, 1),
                                           fm.ntt_prescale_band_plain(c, ring, 1)))
            del c
            # the generator at the c2 shape (n x n dealers), then kernel 1 with
            # gen_noise and the encode there
            bound = pf.error_bound_2
            worst = max(worst, max_abs_err(
                fm.v3k_noise_planes(*V3K_KEY, 0, n, n, ELL, bound, 0, dev),
                tfry.v3k_noise_digit_planes(*V3K_KEY, 0, n, n, ELL, bound, 0, dev)))
            lhs_dig, band, _, _, enc = operands(ring, n, K_DIM, n, 1, "enc32", gen, dev)
            got = fm.matmul_fold_scaled(None, band, ring, lhs_dig=lhs_dig, encode=enc,
                                        encode32=True, noise_bound=bound,
                                        gen_noise=((*V3K_KEY, 0, 0), signed_digit_count(bound),
                                                   bound, "tfry"))
            planes = tfry.v3k_noise_digit_planes(*V3K_KEY, 0, n, n, ELL, bound, 0, dev)
            worst = max(worst, max_abs_err(got, fold_plain_by_limb(ring, band, lhs_dig, planes,
                                                                   enc)))
            # the masked form (a (2, 2) mesh shard's rows [n/4, 3n/4)) there
            lo, hi = n // 4, 3 * n // 4
            got = fm.matmul_fold_scaled(None, band, ring, lhs_dig=lhs_dig, encode=enc,
                                        encode32=True, noise_bound=bound,
                                        gen_noise=((*V3K_KEY, 0, lo, hi, 0),
                                                   signed_digit_count(bound), bound, "tfry"))
            planes = fm.v3k_noise_planes_plain(*V3K_KEY, 0, n, n, ELL, bound, 0, dev,
                                               mask=(lo, hi))
            masked = max_abs_err(got, fold_plain_by_limb(ring, band, lhs_dig, planes, enc,
                                                         mask=(0, lo, hi)))
            masked_worst = max(masked_worst, masked)
            worst = max(worst, masked)
            del lhs_dig, band, enc, got, planes
            torch.cuda.empty_cache()
            check(worst == 0, f"a kernel differs from its twin at nd = {nd}")
            timing[nd] = phase_timing(ring, N_RECEIVERS, K_DIM, dev, card, "num_digits_timing")
            # the path on this width's ring, the keys carried over as residues
            gf = convert.global_pk_from_residues(
                gpk_res, convert.crs_from_residues(crs_res, pf, device=dev))
            sf = P.SecretKey(pf, sk.secret_coeffs)
            ct, ok, ran = path(gf, sf)
            same = (ct.params.ring.num_digits == nd and torch.equal(ct.c1.channel(), base_c1)
                    and torch.equal(ct.c2.channel(), base_c2))
            widths[nd] = {"max_abs_err": worst, "masked_max_abs_err": masked,
                          "bit_identical_to_nd5": same,
                          "shares_exact": ok, "kernel1_ms": timing[nd]["ms"],
                          "launches": {k: v for k, v in ran.items() if v}}
            check(same, f"the ciphertext at nd = {nd} differs from the nd = 5 bytes")
            check(ok, f"party 0's shares at nd = {nd}")
            for name in (fm.KERNEL, fm.NOISE_KERNEL, fm.PRESCALE_KERNEL):
                check(ran[name] > 0, f"{name} never ran on the path at nd = {nd}")
            check(ran[RELAYOUTS] == ran[ROW_RELAYOUTS] == 0, f"operands relaid at nd = {nd}")
            del gf, sf, ct
            torch.cuda.empty_cache()
    finally:
        del settings.num_digits
        get_ring.cache_clear()
    emit({"phase": "num_digits_path", "card": card, "preset": "pvss_8192", "n": n,
          "stream": "v3k", "minimal_nd": params.ring.num_digits, "widths": widths,
          "kernel1_ms_by_nd": {nd: t["ms"] for nd, t in timing.items()},
          "launches": total})
    return {"launches": total}, timing, masked_worst


def phase_examples(card: str) -> dict:
    """The four examples of ``pvw_tpu_torch.examples``, each in a fresh
    interpreter on the card at its default size (``pvw_valid_dec`` at k =
    1024, ``pvw_sharded`` over ``cuda:0`` repeated when one card is
    visible), started together: each must exit 0, and each launches
    kernels 1 and 4. Returns the launches summed over the four."""
    import torch

    from pvw_tpu_torch.ops import fused_modmat as fm

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = {name: subprocess.Popen([sys.executable, "-c", EXAMPLE_RUNNER, name], cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name in EXAMPLES}
    try:
        outs = {name: p.communicate(timeout=600)[0] for name, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    wall_ms = (time.perf_counter() - t0) * 1e3
    total = {name: 0 for name in launches()}
    report = {}
    for name, p in procs.items():
        lines = outs[name].strip().splitlines()
        check(p.returncode == 0, f"example {name} exited {p.returncode}:\n{outs[name][-3000:]}")
        ran = json.loads(lines[-1])["example_launches"]
        report[name] = {"rc": p.returncode, "last_line": lines[-2],
                        "launches": {k: v for k, v in ran.items() if v}}
        for k, v in ran.items():
            total[k] += v
        check(ran[fm.KERNEL] > 0 and ran[fm.PRESCALE_KERNEL] > 0,
              f"example {name} did not launch kernels 1 and 4")
    emit({"phase": "examples", "card": card, "wall_ms": wall_ms, "examples": report,
          "launches": total})
    return {"launches": total}


def kernel_entry(name: str, source: str, replaces: str, function: str, by_path: dict,
                 worst: int, timing: dict, config4: dict | None, card: str, **extra) -> dict:
    """One kernel's entry of the kernels line: its launches on each path,
    its worst difference from its twin, and its times at ``timing``'s
    shape (and config 4's): the median ms beside its plain twin's, its bound
    and the library call's, and where measured its spread and its ratios to
    the bound and the library call."""
    def pick(t):
        return {k: t[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")} | \
            {k: t[k] for k in ("ms_spread", "x_bound", "x_library") if k in t}

    entry = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
             "replaces_function": function, "launches": sum(by_path.values()),
             "launches_by_path": by_path, "bit_exact": worst == 0, "max_abs_err": worst,
             **pick(timing), **extra}
    if config4 is not None:
        entry["config4"] = pick(config4) | {k: config4[k] for k in extra if k in config4}
    entry["card"] = card
    return entry


def probe_entries(by_path: dict, twopass, peak, dots, card: str) -> list:
    """The kernels line's entries of the probes' kernels: ``fold_only``
    (with the two-pass verdict), ``int32_peak`` (its rates) and the three
    dot-structure layouts (kernel 1 bare and the fold's share of it), each
    with ptxas's registers and spills; ``twopass``, ``peak`` and ``dots``
    are (worst difference, timing) of their phases."""
    from pvw_tpu_torch.ops import _build

    src = "pvw_tpu_torch/csrc/"
    (fold_worst, fold), (peak_worst, rec), (dot_worst, dot) = twopass, peak, dots
    dot_ptxas = _build.ptxas_report(DOT_KERNEL)
    return [
        kernel_entry(FOLD_ONLY_KERNEL, src + "fold_only.cu",
                     "benchmarks/probe_twopass.py:119", "fold_only (body _fold_only_body)",
                     by_path[FOLD_ONLY_KERNEL], fold_worst, fold["toy"]["fold_only"],
                     fold["config-4"]["fold_only"], card,
                     ptxas=_build.ptxas_report(FOLD_ONLY_KERNEL),
                     two_pass={label: {k: t[k] for k in ("A_ms", "B_ms", "C_ms", "verdict")}
                               for label, t in fold.items()}),
        kernel_entry(INT32_PEAK_KERNEL, src + "int32_peak.cu",
                     "benchmarks/fold_roofline.py:62", "vpu_peak_kernel",
                     by_path[INT32_PEAK_KERNEL], peak_worst, rec, None, card,
                     ptxas=_build.ptxas_report(INT32_PEAK_KERNEL),
                     **{k: rec[k] for k in ("linearity", "imad_per_s", "jax_ops_per_s",
                                            "int32_ops_per_s")}),
        *(kernel_entry(dot_name(layout), src + "dot_structure.cu",
                       f"benchmarks/probe_dot_structure.py:{line}", function,
                       by_path[dot_name(layout)], dot_worst, dot[layout]["toy"],
                       dot[layout]["config-4"], card,
                       ptxas=[e for e in dot_ptxas
                              if e["template_args"][1:] == [DOT_LAYOUTS.index(layout)]],
                       kernel1_bare_ms=dot[layout]["toy"]["kernel1_bare_ms"],
                       fold_share_of_kernel1=dot[layout]["toy"]["fold_share_of_kernel1"])
          for layout, line, function in (("planes", 91, "pallas_dots"),
                                         ("one_dot", 121, "pallas_one_dot"),
                                         ("wide", 159, "pallas_wide_dot")))]


def main() -> int:
    import torch

    import pvw_tpu_torch as P
    from pvw_tpu_torch import random as R
    from pvw_tpu_torch.config import settings
    from pvw_tpu_torch.ops import _build, fused_modmat as fm
    from pvw_tpu_torch.params import presets
    from pvw_tpu_torch.params.ring import get_ring
    from pvw_tpu_torch.utils import native_decode

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    if sys.argv[1:] == ["mesh_service"]:
        print(card, flush=True)
        emit({"phase": "device", "card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "count": torch.cuda.device_count()})
        check(phase_mesh_service(card) is not None,
              f"mesh_service needs {MULTIPROC_WORLD} cards")
        emit({"ok": True})
        return 0
    t0 = time.perf_counter()
    _build.build_all([fm.KERNEL, fm.PRESCALE_KERNEL, fm.NOISE_KERNEL, fm.PIPELINED_KERNEL,
                      fm.BANDED_KERNEL, fm.DIGITS_KERNEL, FOLD_ONLY_KERNEL,
                      INT32_PEAK_KERNEL, DOT_KERNEL, fm.RESIDUE_NOISE_KERNEL,
                      DECODE_KERNEL, fm.CONTRACTION_KERNEL])
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_decode._lib()
    native_build_s = time.perf_counter() - t0
    print(card, flush=True)
    emit({"phase": "device", "card": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s, "native_build_s": native_build_s,
          "native_library": str(native_decode.library_path())})
    ring = get_ring(MODULI, ELL)
    worst = phase_kernel_vs_plain(ring, dev)
    timing = phase_timing(ring, N_RECEIVERS, K_DIM, dev, card, "timing")
    phase_golden(dev)
    toy_parties = (0, 1, N_RECEIVERS // 2 - 1, N_RECEIVERS - 1)
    paths = {}
    paths["main_path"], ctx = phase_dealer_path(
        "main_path", presets.pvss_8192(N_RECEIVERS), dev, card, 0, "kernel",
        full_parties=toy_parties, wrap_parties=(0, 1, N_RECEIVERS // 2, N_RECEIVERS - 1),
        config="toy chain")
    phase_breakdown(dev, card, ctx)
    settings.noise_stream = "v3k"
    try:
        toy_ct = P.encrypt_all_party_shares_batched(ctx["shares"], ctx["gpk"], R.key(13))
    finally:
        del settings.noise_stream
    phase_crossover(dev, card, {"toy chain": (ctx["params"], toy_ct, ctx["sk"], 0,
                                              CROSSOVER_D_TOY)})
    del ctx, toy_ct
    torch.cuda.empty_cache()
    prescale_worst = phase_prescale_vs_plain(dev)
    deep_worst = phase_deep_kernel_vs_plain(dev)
    deep_timing = phase_deep_timing(dev, card)
    deep = presets.threshold_256bit(DEEP_N)
    deep_info = {"config": "BASELINE config 4", "preset": "threshold_256bit"}
    paths["deep_path"], ctx = phase_dealer_path(
        "deep_path", deep, dev, card, 4, "kernel", full_parties=(0, DEEP_N - 1),
        threshold_parties=(0, 1, DEEP_N // 2 - 1, DEEP_N - 1), **deep_info)
    phase_breakdown(dev, card, ctx, "deep_breakdown")
    deep_keys = (ctx["gpk"], ctx["coeffs"])
    del ctx
    torch.cuda.empty_cache()
    decode_worst, decode_timed = phase_decode_vs_python(dev, card, {
        "toy chain": (presets.pvss_8192(N_RECEIVERS), N_RECEIVERS),
        "config 4": (deep, DEEP_N),
        "reference": (presets.secure_128_reference(REF_N), REF_N)})
    contraction_worst, contraction_timed = phase_contraction(dev, card, {
        "config 4": deep, "reference": presets.secure_128_reference(REF_N)})
    v3k_worst = phase_v3k_vs_plain(dev)
    v3k_timing = phase_v3k_timing(dev, card)
    residue_worst, residue_timing = phase_residue_noise(dev, card)
    swapped_worst = phase_swapped_vs_plain(dev)
    pipelined_worst = phase_pipelined_vs_plain(dev)
    opt_timing = phase_opt_in_timing(dev, card)
    masked_worst = phase_masked_vs_plain(dev)
    banded_worst = phase_banded_vs_plain(dev)
    paths["banded_path"], banded_timing, digits_timing = phase_banded(dev, card)
    masked_timing = phase_masked_timing(dev, card)
    paths["twopass_path"], twopass_worst, twopass_timing = phase_twopass(dev, card)
    paths["int32_peak_path"], peak_worst, peak = phase_int32_peak(dev, card)
    paths["dot_structure_path"], dot_worst, dot_timing = phase_dot_structure(dev, card)
    paths["v3k_path"], ctx = phase_dealer_path(
        "v3k_path", presets.pvss_8192(N_RECEIVERS), dev, card, 5, "v3k",
        full_parties=toy_parties, config="toy chain")
    phase_breakdown(dev, card, ctx, "v3k_breakdown", stream="v3k")
    paths["num_digits_path"], nd_timing, nd_masked_worst = phase_num_digits(dev, card, ctx)
    del ctx
    torch.cuda.empty_cache()
    paths["v3k_deep_path"], _ = phase_dealer_path(
        "v3k_deep_path", deep, dev, card, 6, "v3k", full_parties=(0,),
        threshold_parties=(DEEP_N // 2 - 1, DEEP_N - 1), keys=deep_keys, **deep_info)
    del _
    paths["swapped_path"], ctx = phase_dealer_path(
        "swapped_path", deep, dev, card, 8, "v3k", full_parties=(0,),
        threshold_parties=(DEEP_N - 1,), keys=deep_keys, route="swapped", **deep_info)
    phase_breakdown(dev, card, ctx, "swapped_breakdown", stream="v3k", route="swapped")
    del ctx
    torch.cuda.empty_cache()
    paths.update(phase_backends(dev, card, deep, deep_keys, "v3k", 10))
    paths.update(phase_backends(dev, card, deep, deep_keys, "kernel", 11))
    del deep_keys
    torch.cuda.empty_cache()
    paths["reference_path"], ctx = phase_dealer_path(
        "reference_path", presets.secure_128_reference(REF_N), dev, card, 7, "v3k",
        full_parties=(0, REF_N // 2 - 1, REF_N - 1),
        config="the reference's 128-bit example (examples/pvw_valid_dec.py:40-48)",
        preset="secure_128_reference")
    phase_breakdown(dev, card, ctx, "reference_breakdown", stream="v3k")
    del ctx
    torch.cuda.empty_cache()
    paths["party_path"], ctx = phase_party_path(dev, card, 12)
    phase_crossover(dev, card, {"reference": (ctx["params"], ctx["ct"], ctx["sk"], ctx["party"],
                                              CROSSOVER_D)})
    del ctx
    torch.cuda.empty_cache()
    paths["multiprocess_path"], mesh_worst = phase_multiprocess(card)
    served = phase_mesh_service(card)
    if served is not None:
        paths["mesh_service_path"] = served
    paths["pipelined_path"], ctx = phase_dealer_path(
        "pipelined_path", presets.pvss_8192(N_RECEIVERS), dev, card, 9, "v3k",
        full_parties=(0, N_RECEIVERS - 1), route="pipelined", config="toy chain")
    phase_breakdown(dev, card, ctx, "pipelined_breakdown", stream="v3k", route="pipelined")
    del ctx
    paths["examples"] = phase_examples(card)
    by_path = {name: {path: out["launches"][name] for path, out in paths.items()}
               for name in launches()}
    dm, dp = deep_timing["matmul"], deep_timing["prescale"]
    sw, pi = opt_timing["swapped"], opt_timing["pipelined"]
    src = "pvw_tpu_torch/csrc/"
    emit({"kernels": [
        kernel_entry(fm.KERNEL, src + "fused_scaled_noise_matmul.cu",
                     "pvw_tpu/ops/pallas_modmat.py:672", "_fused_scaled_noise_matmul",
                     by_path[fm.KERNEL],
                     max(worst, timing["max_abs_err"], deep_worst, dm["max_abs_err"],
                         v3k_worst, pi["toy c2"]["max_abs_err"],
                         pi["config-4 c2"]["max_abs_err"], mesh_worst[BARE],
                         *(t["max_abs_err"] for t in nd_timing.values())), timing, dm, card,
                     by_num_digits={nd: {k: t[k] for k in ("ms", "ms_spread", "bound_ms",
                                                           "x_bound", "plain_ms", "library_ms",
                                                           "x_library", "shape")}
                                    for nd, t in nd_timing.items()}),
        kernel_entry(fm.PRESCALE_KERNEL, src + "ntt_prescale_band.cu",
                     "pvw_tpu/ops/pallas_modmat.py:1687", "ntt_prescale_band",
                     by_path[fm.PRESCALE_KERNEL],
                     max(prescale_worst, mesh_worst[fm.PRESCALE_KERNEL]),
                     deep_timing["prescale_toy"],
                     dp, card, raw_ms=deep_timing["prescale_toy"]["raw_ms"]),
        kernel_entry(fm.NOISE_KERNEL, src + "v3k_noise_planes.cu",
                     "pvw_tpu/ops/pallas_modmat.py:232",
                     "_fused_scaled_noise_matmul (in-kernel v3k generation)",
                     by_path[fm.NOISE_KERNEL],
                     max(v3k_worst, mesh_worst[fm.NOISE_KERNEL],
                         *(t["max_abs_err"] for t in v3k_timing.values())),
                     v3k_timing["toy c2"], v3k_timing["config-4 c2"], card,
                     raw_ms=v3k_timing["toy c2"]["raw_ms"],
                     wrapper_host_us=v3k_timing["toy c2"]["wrapper_host_us"]),
        kernel_entry(fm.RESIDUE_NOISE_KERNEL, src + "residue_noise.cu",
                     "none: XLA code (pvw_tpu/sampling/uniform.py:141, pvw_tpu/ops/ntt.py:80)",
                     "sample_uniform_residues_rows + ntt_forward (new)",
                     by_path[fm.RESIDUE_NOISE_KERNEL],
                     max(residue_worst, mesh_worst[fm.RESIDUE_NOISE_KERNEL]),
                     residue_timing["reference c2"], residue_timing["config-4 c2"], card,
                     raw_ms=residue_timing["reference c2"]["raw_ms"],
                     wrapper_host_us=residue_timing["reference c2"]["wrapper_host_us"],
                     ptxas=_build.ptxas_report(fm.RESIDUE_NOISE_KERNEL)),
        kernel_entry(DECODE_KERNEL, src + "pvw_decode.cu",
                     "none: XLA code (pvw_tpu/crypto/device_decode.py, two lax.scan loops)",
                     "decode_residues (new)", by_path[DECODE_KERNEL], decode_worst,
                     decode_timed["reference"], decode_timed["config 4"], card,
                     raw_ms=decode_timed["reference"]["raw_ms"],
                     wrapper_host_us=decode_timed["reference"]["wrapper_host_us"],
                     ptxas=_build.ptxas_report(DECODE_KERNEL)),
        kernel_entry(fm.CONTRACTION_KERNEL, src + "noisy_messages.cu",
                     "none: XLA code (pvw_tpu/crypto/decryption.py:65-78, the digit "
                     "contraction and the inverse NTT)", "_noisy_messages (new)",
                     by_path[fm.CONTRACTION_KERNEL], contraction_worst,
                     contraction_timed["reference"], contraction_timed["config 4"], card,
                     raw_ms=contraction_timed["reference"]["raw_ms"],
                     wrapper_host_us=contraction_timed["reference"]["wrapper_host_us"],
                     ptxas=_build.ptxas_report(fm.CONTRACTION_KERNEL)),
        kernel_entry(fm.SWAPPED_KERNEL, src + "fused_scaled_noise_matmul.cu",
                     "pvw_tpu/ops/pallas_modmat.py:696",
                     "_fused_scaled_noise_matmul (swapped=True, via matmul_fold_swapped)",
                     by_path[fm.SWAPPED_KERNEL],
                     max(swapped_worst, *(t["max_abs_err"] for t in sw.values())),
                     sw["toy c2"], sw["config-4 c2"], card),
        kernel_entry(fm.PIPELINED_KERNEL, src + "fused_pipelined_matmul.cu",
                     "pvw_tpu/ops/pallas_modmat.py:1029", "_fused_pipelined_matmul",
                     by_path[fm.PIPELINED_KERNEL],
                     max(pipelined_worst, *(t["max_abs_err"] for t in pi.values())),
                     pi["toy c2"], pi["config-4 c2"], card,
                     banded_plus_generator_ms=pi["toy c2"]["banded_plus_generator_ms"]),
        kernel_entry(fm.MASKED_KERNEL, src + "fused_scaled_noise_matmul.cu",
                     "pvw_tpu/ops/pallas_modmat.py:193",
                     "_fused_scaled_noise_matmul (masked=True, 6-word seeds; its planes from "
                     "v3k_noise_planes.cu's mask)", by_path[fm.MASKED_KERNEL],
                     max(masked_worst["masked"], mesh_worst[fm.MASKED_KERNEL], nd_masked_worst,
                         *(t["max_abs_err"] for t in masked_timing["masked"].values())),
                     masked_timing["masked"]["toy c2"], masked_timing["masked"]["config-4 c2"],
                     card, post={label: t | {"max_abs_err": max(masked_worst["post"],
                                                                t["max_abs_err"])}
                                 for label, t in masked_timing["post"].items()}),
        kernel_entry(fm.BANDED_KERNEL, src + "banded_matmul.cu",
                     "pvw_tpu/ops/pallas_modmat.py:426", "_fused_banded_matmul",
                     by_path[fm.BANDED_KERNEL],
                     max(banded_worst, *(t["max_abs_err"] for t in banded_timing.values())),
                     banded_timing["toy"], banded_timing["config-4"], card,
                     includes=src + "wgmma_digit.cuh",
                     entry_ms=banded_timing["toy"]["entry_ms"],
                     layout_ms=banded_timing["toy"]["layout_ms"]),
        kernel_entry(fm.DIGITS_KERNEL, src + "digit_planes.cu",
                     "pvw_tpu/ops/pallas_modmat.py:1532",
                     "matmul_channels_pallas's digit split (XLA, ahead of "
                     "_fused_banded_matmul)", by_path[fm.DIGITS_KERNEL],
                     max(t["max_abs_err"] for t in digits_timing.values()),
                     digits_timing["toy"], digits_timing["config-4"], card),
        *probe_entries(by_path, (twopass_worst, twopass_timing), (peak_worst, peak),
                       (dot_worst, dot_timing), card),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
