"""The (recv, kdim) mesh across processes on ``torch.distributed``, the
counterpart of ``pvw_tpu.parallel.multiprocess``.

Every other backend of the port runs its shards one after another in one
process. Here each process (rank) runs the shards it owns at the same time
as the others, and every collective crosses process boundaries: the kdim
partials meet by ``all_gather`` on each recv row's group of ranks and are
added mod q (``_modsum_gathered``; ``all_reduce(SUM)`` would leave the
residues unreduced), and c1 is broadcast from the recv-row-0 group to every
rank. All randomness is counter-based and keyed by global row and column,
so each rank computes the whole single-device encryption itself and checks
exactly the shards it owns, byte for byte; no result is shipped for the
check.

The global mesh is ``(world * local / kdim, kdim)`` in rank-major order
(global device g = rank * local + j sits at (g // kdim, g % kdim)), as
``jax.devices()`` orders the JAX package's. A rank's local shards run on
its one device: ``cuda:(rank mod device_count)``, made current before the
process group starts, or the CPU. The backend follows the topology: NCCL
when every rank has a card of its own, gloo when ranks share a card and on
the CPU. Under gloo the collectives move host copies of the partials
(the "host" transport); under NCCL they move the device tensors.

Two entry points:

- :func:`run_worker`, run by each spawned process (``python -m
  pvw_tpu_torch.parallel.multiprocess <rank> <world> <port> <local>
  [--device cpu|cuda] [--params JSON] [--dealers D] ...``);
- :func:`dryrun_multiprocess`, the launcher: spawns the workers as fresh
  interpreters, waits, and raises unless every one verified its shards.

The system is the caller's parameters (``PvwParameters.to_dict``) and
dealer count, by default the JAX worker's (:func:`default_params`, 8
dealers). Each worker prints the JAX package's ``MULTIPROC-OK`` line and
one JSON line ``{"multiproc_stats": {...}}``: its kernel launches
(``fused_modmat.launch_counters``) and device decodes over the sharded run
(products, collectives, decryption and decode), its stage times (host
clock around a synchronize), the backend and the transport. Set-up is
timed apart from the run: the communicators' first collective, the
system, and a recv row head's first decode (which loads its ops'
kernels), on zero residues.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field

OK_MARKER = "MULTIPROC-OK"
STATS_KEY = "multiproc_stats"
# the JAX worker's system: the 4 x 55-bit chain, n = k = 32, d = 8
TEST_MODULI = (0x80000000080001, 0x80000000130001, 0x80000000190001, 0x800000001D0001)
TEST_NK, TEST_DEALERS = 32, 8
KDIM = 2                       # the mesh's kdim, as in the JAX worker
PARTY = 1                      # the party that decrypts, as in the JAX worker


def default_params():
    """The JAX worker's parameters: the 4 x 55-bit chain, n = k = 32, l = 8,
    variance 0.5, the suggested bounds."""
    from ..params import PvwParameters, PvwParametersBuilder

    b1, b2 = PvwParameters.suggest_error_bounds(TEST_NK, TEST_NK, 8, TEST_MODULI, 0.5)
    return (PvwParametersBuilder().set_parties(TEST_NK).set_dimension(TEST_NK).set_l(8)
            .set_moduli(TEST_MODULI).set_secret_variance(0.5).set_error_bounds_u32(b1, b2)
            .build())


def build_system(params, dealers: int, device):
    """The JAX worker's deterministic system on ``device``, built the same
    by every rank: the CRS, n parties' keys, ``dealers`` rows of scalars
    dd * 10 + r + 1 and the encryption key. Returns (gpk, parties,
    vectors, enc_key)."""
    import numpy as np

    from .. import random as R
    from ..keys import GlobalPublicKey, Party
    from ..params import PvwCrs

    n = params.n
    key = R.key(0)
    crs = PvwCrs.new(params, R.fold_in(key, 0), device=device)
    parties = [Party.new(i, params, R.fold_in(key, 100 + i), device=device) for i in range(n)]
    gpk = GlobalPublicKey(crs)
    gpk.generate_all_party_keys(parties, R.fold_in(key, 1))
    vectors = np.array([[dd * 10 + r + 1 for r in range(n)] for dd in range(dealers)], np.uint64)
    return gpk, parties, vectors, R.fold_in(key, 5)


def choose_backend(device_type: str, world: int, cards: int, backend: str | None = None) -> str:
    """``nccl`` when every rank has a card of its own (``world <= cards``),
    ``gloo`` when ranks share a card and on the CPU. An explicit ``nccl``
    where the topology does not allow it raises (NCCL refuses two ranks on
    one card); nothing switches backends on its own."""
    from ..errors import InvalidParameters

    auto = "nccl" if device_type == "cuda" and world <= cards else "gloo"
    if backend is None:
        return auto
    if backend not in ("gloo", "nccl"):
        raise InvalidParameters(f"backend {backend!r}: one of gloo, nccl")
    if backend == "nccl" and auto != "nccl":
        raise InvalidParameters(
            f"nccl needs a card for every rank: {world} ranks on {cards} "
            f"{device_type} card(s); use gloo")
    return backend


class MeshLayout:
    """Which rank owns which shard of the global (recv, kdim) mesh of
    ``world * local`` devices, rank-major; ``row_ranks[r]`` are the ranks
    holding recv row r's shards, in kdim order."""

    def __init__(self, world: int, local: int, kdim: int) -> None:
        from ..errors import InvalidParameters

        total = world * local
        if kdim < 1 or total % kdim:
            raise InvalidParameters(f"{total} devices not divisible by kdim={kdim}")
        if local % kdim and kdim % local:
            raise InvalidParameters(
                f"local devices {local} and kdim {kdim}: one must divide the other, so that "
                "every rank holds the same number of shards of a recv row")
        self.world, self.local, self.kdim = world, local, kdim
        self.recv = total // kdim
        self.row_ranks = [sorted({(r * kdim + j) // local for j in range(kdim)})
                          for r in range(self.recv)]

    def owner(self, r: int, j: int) -> int:
        return (r * self.kdim + j) // self.local

    def shards(self, rank: int) -> list:
        """(recv, kdim) index of each shard ``rank`` owns, in order."""
        return [divmod(g, self.kdim) for g in range(rank * self.local, (rank + 1) * self.local)]


def _gather(parts: list, group, host: bool, device) -> list:
    """A recv row's partials in kdim order on every rank of the row: this
    rank's ``parts`` (its shards of the row, kdim order) gathered over
    ``group`` (None: the row is this rank's alone). ``host``: the
    collective moves host copies (gloo)."""
    import torch
    import torch.distributed as dist

    if group is None:
        return parts
    mine = torch.stack(parts)
    if host:
        mine = mine.cpu()
    out = [torch.empty_like(mine) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, mine, group=group)
    return [p.to(device) for t in out for p in t.unbind(0)]


@dataclass
class _Clock:
    device: object
    times: dict = field(default_factory=dict)

    def sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __call__(self, name: str, fn):
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out


def run_worker(rank: int, world: int, port: int, local_devices: int, *, device: str = "cuda",
               params: dict | None = None, dealers: int | None = None,
               stream: str | None = None, backend: str | None = None,
               timeout_s: float = 600.0) -> dict:
    """One rank of the mesh across processes (see the module docstring) on
    ``params`` (the dict form; default :func:`default_params`) with
    ``dealers`` dealers (default 8). Raises unless its c1 and owned c2 rows
    equal its single-device encryption byte for byte and its owned dealers
    decode exactly; prints the OK line and the stats line, and returns the
    stats."""
    import datetime

    import torch
    import torch.distributed as dist

    from ..config import settings
    from ..crypto import device_decode
    from ..crypto.decryption import _contraction, _decode_batch, _noisy_finish
    from ..crypto.encryption import _host_noise_pairs, encrypt_batch
    from ..errors import InvalidParameters
    from ..ops import fused_modmat as fm, u64 as u64op
    from ..params import PvwParameters
    from ..utils.device import resolve_device
    from .sharding import (_check_batch, _finish_row, _modsum_gathered, _shard_operands,
                           _shard_products)

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, world, cards, backend)
    host = backend == "gloo"
    layout = MeshLayout(world, local_devices, KDIM)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        # every rank enters every new_group, in the same order
        groups = [dist.new_group(ranks) if len(ranks) > 1 else None
                  for ranks in layout.row_ranks]
        if stream is not None:
            settings.noise_stream = stream
        clock = _Clock(dev)

        def comm_setup():
            # communicators start at their first collective: one small one on
            # every group of this rank, so that the timed run moves data only
            probe = torch.zeros(1, dtype=torch.int64, device="cpu" if host else dev)
            for ranks, group in zip(layout.row_ranks, groups):
                if group is not None and rank in ranks:
                    dist.all_gather([torch.empty_like(probe) for _ in ranks], probe, group=group)
            dist.broadcast(probe, src=0)

        clock("comm_setup_ms", comm_setup)
        params = default_params() if params is None else PvwParameters.from_dict(params)
        if not device_decode.decode_supported(params):
            raise InvalidParameters("the device decode does not cover these parameters")
        d = TEST_DEALERS if dealers is None else dealers
        gpk, parties, vectors, enc_key = clock("system_ms",
                                               lambda: build_system(params, d, dev))
        ring, n, k = params.ring, params.n, params.k
        nr, kd = layout.recv, KDIM
        if n % nr or k % kd or d % nr:
            raise InvalidParameters(f"n={n} and d={d} over recv={nr}, k={k} over kdim={kd}")
        nl, kc, dl = n // nr, k // kd, d // nr
        mine = layout.shards(rank)
        my_rows = sorted({r for r, _ in mine})
        heads = [r for r in my_rows if layout.owner(r, 0) == rank]
        if heads:
            # a head's first decode loads its ops' kernels: on zero residues
            clock("decode_warmup_ms", lambda: _decode_batch(
                torch.zeros((dl, ring.num_limbs, ring.degree), dtype=torch.int64,
                            device=dev), params, "device"))

        # the rank's single-device reference; only what it checks is kept
        ct_ref = clock("reference_encrypt_ms", lambda: encrypt_batch(vectors, gpk, enc_key))
        ref_c1 = ct_ref.c1.channel().cpu()                                 # [L, l, k, d]
        ref_c2 = {r: ct_ref.c2.channel()[:, :, r * nl:(r + 1) * nl].cpu() for r in my_rows}
        ref_c2_party = ct_ref.c2.channel()[:, :, PARTY].cpu()              # [L, l, d]
        del ct_ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        _check_batch(vectors, params, gpk)
        a_dig, b_dig = gpk.encrypt_operands()
        # the ranks start the sharded run together: the slowest rank's
        # products + gather is the encryption's time
        clock.sync()
        dist.barrier(**({"device_ids": [dev.index]} if backend == "nccl" else {}))
        for fn, attr in fm.launch_counters().values():
            setattr(fn, attr, 0)
        device_decode.decode_residues.calls = 0
        sc = u64op.u64_tensor(vectors, dev)
        host_e1, host_e2 = _host_noise_pairs(params, enc_key, d, dev)
        kstream = settings.kernel_noise_stream()
        encode32 = int(vectors.max(initial=0)) < 1 << 32

        def products():
            return {(r, j): _shard_products(
                params, *_shard_operands(a_dig, b_dig, sc, r, j, nl, kc, ring.num_digits, dev),
                enc_key, r, j, kd, nl, host_e1, host_e2, False, kstream, encode32, dev)
                for r, j in mine}

        parts = clock("sharded_products_ms", products)

        def gather_modsum():
            c1 = None
            c2 = {}
            for r in my_rows:
                cols = sorted(j for rr, j in mine if rr == r)
                c1_parts = (_gather([parts[(r, j)][0] for j in cols], groups[r], host, dev)
                            if r == 0 else None)
                c2_parts = _gather([parts[(r, j)][1] for j in cols], groups[r], host, dev)
                row_c1, c2[r] = _finish_row(params, r, nl, kd, c1_parts, c2_parts, dev,
                                            host_e1, host_e2)
                if r == 0:
                    c1 = row_c1
            # c1 replicated to every rank from rank 0 (recv row 0's head)
            if c1 is None:
                c1 = torch.empty((ring.num_limbs, ring.degree, k, d), dtype=torch.int64,
                                 device=dev)
            buf = c1.cpu() if host else c1
            dist.broadcast(buf, src=0)
            return buf.to(dev), c2

        c1, c2 = clock("gather_modsum_ms", gather_modsum)
        del parts
        if not torch.equal(c1.cpu(), ref_c1):
            raise RuntimeError(f"rank {rank}: c1 differs from the single-device encryption")
        for r in my_rows:
            if not torch.equal(c2[r].cpu(), ref_c2[r]):
                raise RuntimeError(f"rank {rank}: c2 rows of recv row {r} differ from the "
                                   "single-device encryption")
        rows_checked = nl * len(my_rows)

        # decryption across the processes (party 1): the dealers over recv,
        # the k contraction over kdim; each row's head decodes on the device
        sk = parties[PARTY].secret_key.to_polynomials(dev).res                # [k, L, l]
        c1_ch = ref_c1.to(dev)

        def decrypt():
            out = {}
            for r in my_rows:
                dls = slice(r * dl, (r + 1) * dl)
                cols = sorted(j for rr, j in mine if rr == r)
                row = _gather([_contraction(ring, sk[j * kc:(j + 1) * kc],
                                            c1_ch[:, :, j * kc:(j + 1) * kc, dls])
                               for j in cols], groups[r], host, dev)
                if r in heads:
                    out[r] = _noisy_finish(ring, _modsum_gathered(row, ring, dev),
                                           ref_c2_party[:, :, dls])
            return out

        z = clock("decrypt_ms", decrypt)
        msgs_checked = 0
        for r, zr in z.items():
            want = [int(v) for v in vectors[r * dl:(r + 1) * dl, PARTY]]
            got = clock("decode_ms", lambda: _decode_batch(zr, params, "device"))
            if got != want:
                raise RuntimeError(f"rank {rank}: recv row {r} decrypted {got[:4]}..., "
                                   f"expected {want[:4]}...")
            msgs_checked += len(got)
        counts = {name: getattr(fn, attr) for name, (fn, attr) in fm.launch_counters().items()}
        stats = {
            "rank": rank, "world": world, "local_devices": local_devices,
            "mesh": [nr, kd], "shards": [list(s) for s in mine],
            "n": n, "k": k, "dealers": d, "num_digits": ring.num_digits,
            "stream": kstream or "v3", "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "backend": backend, "transport": "host" if host else "device",
            "cross_process_rows": [r for r in my_rows if groups[r] is not None],
            "rows_checked": rows_checked, "msgs_checked": msgs_checked,
            "launches": counts, "decodes": device_decode.decode_residues.calls,
            "times_ms": clock.times,
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None)}
        dist.barrier(**({"device_ids": [dev.index]} if backend == "nccl" else {}))
    finally:
        dist.destroy_process_group()
    print(f"{OK_MARKER} p{rank}/{world}: mesh (recv={nr}, kdim={kd}) over {world} processes x "
          f"{local_devices} devices; encrypt bit-identical ({rows_checked} owned c2 rows + "
          f"replicated c1), sharded device-decode decrypt exact ({msgs_checked} owned "
          f"messages)", flush=True)
    print(json.dumps({STATS_KEY: stats}), flush=True)
    return stats


def _probe_free_port() -> int:
    """An OS-assigned free TCP port (bind-probe); a race between the probe
    and rank 0's bind is handled by the launcher's retry."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_command(rank: int, world: int, port: int, local_devices: int, opts: list) -> list:
    """The command line of one worker: a fresh interpreter (never a fork
    of a process that may hold a CUDA context)."""
    return [sys.executable, "-m", "pvw_tpu_torch.parallel.multiprocess", str(rank), str(world),
            str(port), str(local_devices), *opts]


@dataclass
class MultiprocResult:
    """The launcher's summary line and each rank's stats (rank order)."""

    summary: str
    ranks: list

    def __str__(self) -> str:
        return self.summary


def dryrun_multiprocess(num_processes: int = 2, local_devices: int = 2,
                        timeout_s: float = 600.0, attempts: int = 3, *, device: str = "cuda",
                        params=None, dealers: int | None = None,
                        stream: str | None = None,
                        backend: str | None = None) -> MultiprocResult:
    """Spawn ``num_processes`` workers (:func:`run_worker`), each holding
    ``local_devices`` shards of the (recv, kdim) mesh, on ``device``
    ("cuda", the default, raises without a card; "cpu"), at ``params``
    (``PvwParameters``; default the JAX worker's) with ``dealers`` dealers
    (default 8). ``backend`` asks for one (an NCCL the topology does not
    allow raises); by default it follows the topology. Raises unless
    every worker verified its shards. Worker output goes to temp files; a
    worker that dies early kills the rest and the launch is retried on a
    fresh port (a port race); a timeout is not retried and names the
    workers that never verified."""
    import tempfile

    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, num_processes, cards, backend)
    MeshLayout(num_processes, local_devices, KDIM)
    opts = ["--device", dev.type, "--backend", backend, "--timeout", str(timeout_s)]
    if params is not None:
        opts += ["--params", json.dumps(params.to_dict())]
    if dealers is not None:
        opts += ["--dealers", str(dealers)]
    if stream is not None:
        opts += ["--stream", stream]
    env = dict(os.environ)
    cwd = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    last_failure = None
    for attempt in range(attempts):
        port = _probe_free_port()
        files, procs = [], []
        for rank in range(num_processes):
            f = tempfile.TemporaryFile("w+")
            files.append(f)
            procs.append(subprocess.Popen(
                _worker_command(rank, num_processes, port, local_devices, opts),
                stdout=f, stderr=subprocess.STDOUT, text=True, env=env, cwd=cwd))
        deadline = time.time() + timeout_s
        timed_out = early_fail = False
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                early_fail = True           # a worker died; the rest would
                break                       # wait on the group forever
            if time.time() > deadline:
                timed_out = True
                break
            time.sleep(0.25)
        if timed_out or early_fail:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p in procs:
            p.wait()
        outs = []
        for f in files:
            f.seek(0)
            outs.append(f.read())
            f.close()
        rcs = [p.returncode for p in procs]
        if (not timed_out and all(rc == 0 for rc in rcs)
                and all(OK_MARKER in o for o in outs)):
            ranks = [json.loads(line)[STATS_KEY] for o in outs for line in o.splitlines()
                     if line.startswith('{"' + STATS_KEY)]
            return MultiprocResult(
                f"multiprocess mesh OK: {num_processes} processes x {local_devices} devices "
                f"on {dev.type} over {backend}, encrypt+decrypt bit-identical across process "
                "boundaries", ranks)
        status = []
        for rank, (rc, out) in enumerate(zip(rcs, outs)):
            state = ("verified" if OK_MARKER in out else
                     "never initialized" if not out.strip() else
                     "started but did not verify")
            status.append(f"  worker {rank}: rc={rc}, {state}\n"
                          f"  --- output ---\n{out.strip() or '(empty)'}")
        last_failure = (
            f"{'timed out' if timed_out else 'worker died early'} on port {port} "
            f"(attempt {attempt + 1}/{attempts}):\n" + "\n".join(status))
        if timed_out:
            break                   # a timeout is not a port race; don't loop
    raise RuntimeError(f"multi-process dryrun failed: {last_failure}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one rank of the mesh across processes")
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("local_devices", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--params", type=json.loads, default=None,
                    help="PvwParameters.to_dict() as JSON (default: the JAX worker's)")
    ap.add_argument("--dealers", type=int, default=None)
    ap.add_argument("--stream", default=None)
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    run_worker(a.rank, a.world, a.port, a.local_devices, device=a.device, params=a.params,
               dealers=a.dealers, stream=a.stream, backend=a.backend, timeout_s=a.timeout)


if __name__ == "__main__":
    main()
