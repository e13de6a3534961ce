"""The (recv, kdim) mesh across processes on ``torch.distributed``, the
counterpart of ``pvw_tpu.parallel.multiprocess``, served round by round.

Every other backend of the port runs its shards one after another in one
process. Here each process (rank) runs the shards it owns at the same time
as the others, and every transfer crosses process boundaries.

:class:`MeshRank` is one rank of a served mesh. It holds only its recv
rows' public keys (:class:`~pvw_tpu_torch.keys.PublicKeyRows`: made from
those rows' secret coefficients, e1 keyed by global row), the digit planes
of its shards' k-column blocks (and of A's, on recv row 0), and its recv
rows' scalars in host memory, a pool of slots. A round: rank 0 sends the
round's index, slot and key in one small collective; each rank uploads its
scalars, draws its k block of r and runs its shards' products (the stages
of :func:`~pvw_tpu_torch.parallel.sharding._shard_products`, written once);
then the kdim partials of each recv row are combined exactly: row block b
is finished by the rank that holds shard (row, b), which receives every
other shard's block b (point-to-point, batched) and adds them mod q (a
plain or NCCL ``SUM`` would leave the residues unreduced). So c2's rows
are finished on their recv row, each rank finishing its block, and c1's on
recv row 0. The round ends at a completion collective that every rank
enters after its own synchronize, with its status: a rank whose round
raised fails the round on rank 0. Every stage is a span: ``pvw.mesh.round``
and ``.upload``, ``.r_stage``, ``.products`` (kernel 1), ``.bake`` (the
residue noise and the encode added into the shard's block), ``.gather``
(the transfers, with the bytes received and sent and their count),
``.modsum`` and ``.finish`` (the host noise of bounds >= min q, the kept
columns, the synchronize and the completion collective).

:class:`MeshService` is the caller's side: its process is rank 0 on the
first device. It starts ranks 1.. as fresh interpreters (``python -m
pvw_tpu_torch.parallel.multiprocess serve <rank> <spec JSON>``), one a
device, and meets them at a TCP store it binds itself. Each rank makes its inputs with a function the caller names
(``path.py:function``): its rows' secret coefficients, its scalar pool,
the dealer columns it keeps of the rounds asked to be kept. Rank 0 can
read every rank's kernel launches (:meth:`MeshService.launches`). A rank
exits when rank 0 releases it or dies; a rank that dies fails the next
round.

The global mesh is ``(world * local / kdim, kdim)`` in rank-major order
(global device g = rank * local + j sits at (g // kdim, g % kdim)), as
``jax.devices()`` orders the JAX package's. A rank's local shards run on
its one device: ``cuda:(rank mod device_count)``, made current before the
process group starts, or the CPU. The backend follows the topology: NCCL
when every rank has a card of its own, gloo when ranks share a card and on
the CPU. Under gloo the transfers move host copies (the "host" transport);
under NCCL the device tensors. The small control collectives go over a gloo
group of their own, whose timeout is twice the transfers'.

The dry run, one round on the served rank at a small system:

- :func:`run_worker`, run by each spawned process (``python -m
  pvw_tpu_torch.parallel.multiprocess <rank> <world> <port> <local>
  [--device cpu|cuda] [--params JSON] [--dealers D] ...``);
- :func:`dryrun_multiprocess`, the launcher: spawns the workers as fresh
  interpreters, waits, and raises unless every one verified its shards.

The system is the caller's parameters (``PvwParameters.to_dict``) and
dealer count, by default the JAX worker's (:func:`default_params`, 8
dealers). Each rank makes its recv rows' keys from those parties' secrets
alone and serves one round; then it checks its keys' rows and its finished
rows against its own single-device encryption of the whole system, byte
for byte, and decrypts across the processes. Each worker prints the JAX
package's ``MULTIPROC-OK`` line and one JSON line ``{"multiproc_stats":
{...}}``: its kernel launches (``fused_modmat.launch_counters``) and device
decodes over the round and the decryption, its stage times (the card ms
of the round's stage spans; host ms on the CPU), the backend and the
transport. Set-up is timed
apart from the run: the rank's keys, the communicators' first collective,
and a recv row head's first decode (which loads its ops' kernels), on zero
residues.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field

OK_MARKER = "MULTIPROC-OK"
STATS_KEY = "multiproc_stats"
# the JAX worker's system: the 4 x 55-bit chain, n = k = 32, d = 8
TEST_MODULI = (0x80000000080001, 0x80000000130001, 0x80000000190001, 0x800000001D0001)
TEST_NK, TEST_DEALERS = 32, 8
KDIM = 2                       # the mesh's kdim, as in the JAX worker
PARTY = 1                      # the party that decrypts, as in the JAX worker
# the words rank 0 sends the served ranks: command, round, slot, keep, key words
ROUND, COLLECT, RELEASE, LAUNCHES = 1, 2, 3, 4
MSG_WORDS = 6
START_S = 600.0                # the longest a served rank may take to make its keys


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


def _block(rows: int, kd: int, b: int, stored: int | None = None) -> tuple[int, int]:
    """Rows [lo, hi) of block b of a partial of ``rows`` rows cut into kd
    blocks of ceil(rows / kd): of the ``stored`` rows (padding included; the
    bake route pads to kd whole blocks), or, without ``stored``, of the
    finished rows."""
    blk = -(-rows // kd)
    end = rows if stored is None else stored
    return min(b * blk, end), min((b + 1) * blk, end)


def _host_int64(arr, pin: bool):
    """A u64 array's bit patterns as a host int64 tensor, pinned with ``pin``
    (so that its upload runs at the link's rate, off the host's clock)."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.uint64)).view(np.int64).copy())
    return t.pin_memory() if pin else t


@dataclass
class RankView:
    """What a rank's input function is given: its rank, its recv rows'
    global party ranges {row: (lo, hi)}, its device, the parameters and the
    caller's arguments."""

    rank: int
    rows: dict
    device: object
    params: object
    args: dict


def load_inputs(ref: str):
    """The function ``path.py:function`` names (the file loaded by path)."""
    path, _, name = ref.rpartition(":")
    spec = importlib.util.spec_from_file_location(
        "pvw_mesh_inputs_" + os.path.basename(path).replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


class MeshRank:
    """One rank of the served (recv, kdim) mesh (see the module docstring).

    ``coeffs``: {recv row: int32 [n / recv, k, l]}, the secret coefficients
    of the parties of each of this rank's recv rows; ``pool``: a list of
    slots, each {recv row: u64 [d, n / recv]}, the scalars of the row's
    parties (dealer by party); ``keep_cols``: the dealer columns of c2 a
    kept round keeps (default all). The process group starts with
    :meth:`connect`."""

    def __init__(self, rank: int, layout: "MeshLayout", params, device, crs_key, gen_key,
                 coeffs: dict, pool: list, keep_cols=None) -> None:
        import numpy as np
        import torch

        from ..errors import InvalidParameters
        from ..keys.public_key import PublicKeyRows
        from ..params import PvwCrs

        n, k, kd = params.n, params.k, layout.kdim
        if n % layout.recv or k % kd:
            raise InvalidParameters(f"n={n} over recv={layout.recv}, k={k} over kdim={kd}")
        if not params.verify_correctness_condition():
            raise InvalidParameters(
                "Parameters do not satisfy correctness condition - decryption may fail")
        self.rank, self.layout, self.params = rank, layout, params
        self.dev = torch.device(device)
        self.nl, self.kc = n // layout.recv, k // kd
        self.mine = layout.shards(rank)
        self.rows = sorted({r for r, _ in self.mine})
        t0 = time.perf_counter()
        self.crs = PvwCrs.new(params, crs_key, device=self.dev)
        self.keys = {r: PublicKeyRows.generate_device(self.crs, coeffs[r], gen_key, r * self.nl)
                     for r in self.rows}
        self.ops = {(r, j): self.keys[r].encrypt_operands((j * self.kc, self.kc),
                                                          with_a=r == 0)
                    for r, j in self.mine}
        self._sync()
        t1 = time.perf_counter()
        pin = self.dev.type == "cuda"
        self.pool = [{r: _host_int64(slot[r], pin) for r in self.rows} for slot in pool]
        #: host ms of this rank's set-up steps
        self.setup_ms = {"keys_ms": (t1 - t0) * 1e3,
                         "pool_ms": (time.perf_counter() - t1) * 1e3}
        self.encode32 = [{r: int(np.asarray(slot[r], np.uint64).max(initial=0)) < 1 << 32
                          for r in self.rows} for slot in pool]
        self.d = self.pool[0][self.rows[0]].shape[0]
        if any(t.shape != (self.d, self.nl) for slot in self.pool for t in slot.values()):
            raise InvalidParameters(f"every slot's scalars of a recv row: [{self.d}, {self.nl}]")
        self.keep_cols = None if keep_cols is None else torch.as_tensor(
            keep_cols, dtype=torch.int64, device=self.dev)
        self.kept: dict = {}                # round -> its kept blocks
        self.last = None                    # (round, its finished blocks)

    # -- the process group -------------------------------------------------

    def connect(self, backend: str, timeout_s: float, *, port: int | None = None,
                store=None) -> None:
        """Join the process group (a TCP store, or ``tcp://localhost:port``)
        and make the row groups and the gloo control group; every rank makes
        them in the same order. A transfer waits at most ``timeout_s``."""
        import datetime

        import torch.distributed as dist

        self.backend, self.host = backend, backend == "gloo"
        self.timeout = datetime.timedelta(seconds=timeout_s)
        if backend == "nccl":
            # a collective that waits past the timeout raises, failing its round
            os.environ.setdefault("TORCH_NCCL_BLOCKING_WAIT", "1")
        where = {"store": store} if store is not None else {
            "init_method": f"tcp://localhost:{port}"}
        dist.init_process_group(backend, world_size=self.layout.world, rank=self.rank,
                                timeout=datetime.timedelta(seconds=timeout_s), **where)
        self.row_groups = [dist.new_group(ranks) if len(ranks) > 1 else None
                           for ranks in self.layout.row_ranks]
        # the control words and the completion go over gloo with a longer
        # timeout, so that a rank whose transfer timed out still reports
        self.ctrl = dist.new_group(backend="gloo",
                                   timeout=datetime.timedelta(seconds=2 * timeout_s + 30))

    def warm_comms(self) -> None:
        """Communicators start at their first collective: one small one on
        every group of this rank, so that a timed round moves data only."""
        import torch
        import torch.distributed as dist

        probe = torch.zeros(1, dtype=torch.int64, device="cpu" if self.host else self.dev)
        for ranks, group in zip(self.layout.row_ranks, self.row_groups):
            if group is not None and self.rank in ranks:
                dist.all_gather([torch.empty_like(probe) for _ in ranks], probe, group=group)
                # and the point-to-point path of the round's transfers
                peers = [q for q in ranks if q != self.rank]
                ops = ([dist.P2POp(dist.isend, probe, q, group) for q in peers]
                       + [dist.P2POp(dist.irecv, torch.empty_like(probe), q, group)
                          for q in peers])
                for w in dist.batch_isend_irecv(ops):
                    w.wait(self.timeout)
        dist.broadcast(probe, src=0)
        dist.broadcast(torch.zeros(1, dtype=torch.int64), src=0, group=self.ctrl)

    def _sync(self) -> None:
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    # -- control -------------------------------------------------------------

    def _message(self, words=()) -> list[int]:
        """Rank 0 sends ``words`` (padded to MSG_WORDS) to every rank; the
        others receive them."""
        import torch
        import torch.distributed as dist

        msg = torch.zeros(MSG_WORDS, dtype=torch.int64)
        if self.rank == 0:
            msg[:len(words)] = torch.tensor([int(w) for w in words], dtype=torch.int64)
        dist.broadcast(msg, src=0, group=self.ctrl)
        return msg.tolist()

    def round(self, i: int, slot: int, key, keep: bool = False) -> None:
        """Rank 0: round ``i`` on every rank, the scalars of pool ``slot``
        under ``key`` (a key tensor [2]); ``keep``: every rank keeps its
        finished c1 rows and c2's kept columns for :meth:`collect`. Returns
        when every rank holds its finished rows; raises if any rank's round
        failed."""
        k0, k1 = (int(w) for w in key)
        self._message((ROUND, i, slot, int(keep), k0, k1))
        failed = self._round_and_complete(i, slot, (k0, k1), keep)
        if failed:
            raise RuntimeError(f"mesh round {i} failed on rank(s) {failed}"
                               + (f"; rank 0: {self.error}" if self.error else ""))

    def serve(self) -> None:
        """Ranks but 0: do what rank 0 asks until it releases them."""
        while True:
            cmd, i, slot, keep, k0, k1 = self._message()[:6]
            if cmd == RELEASE:
                return
            if cmd == ROUND:
                self._round_and_complete(i, slot, (k0, k1), bool(keep))
            elif cmd == COLLECT:
                self._collect(self._rounds_asked(i))
            elif cmd == LAUNCHES:
                self._launches(bool(i))
            else:
                raise RuntimeError(f"rank {self.rank}: unknown command {cmd}")

    def release(self) -> None:
        """Rank 0: end the other ranks' :meth:`serve`."""
        self._message((RELEASE,))

    def launches(self, reset: bool = False) -> list[dict]:
        """Rank 0: every rank's kernel launches since its last reset
        (``fused_modmat.launch_counters``), rank order; ``reset``: each rank
        sets its counts to 0 after reading them."""
        self._message((LAUNCHES, int(reset)))
        return self._launches(reset)

    def _launches(self, reset: bool) -> list[dict]:
        import torch.distributed as dist

        from ..ops import fused_modmat as fm

        counts = {name: getattr(fn, attr) for name, (fn, attr) in fm.launch_counters().items()}
        if reset:
            for fn, attr in fm.launch_counters().values():
                setattr(fn, attr, 0)
        out = [None] * self.layout.world
        dist.all_gather_object(out, counts, group=self.ctrl)
        return out

    # -- a round ---------------------------------------------------------------

    def _round_and_complete(self, i: int, slot: int, key, keep: bool) -> list[int]:
        """This rank's part of round i and the completion collective; the
        ranks whose round failed (this one's traceback to its stderr)."""
        from ..utils.profiling import span

        self._completed, self.error = False, None
        with span("pvw.mesh.round", round=i, dealers=self.d, rank=self.rank):
            try:
                return self._round(i, slot, key, keep)
            except Exception as e:
                if self._completed:
                    raise
                traceback.print_exc()
                self.last, self.error = None, repr(e)
                return self._complete(False)

    def _complete(self, ok: bool) -> list[int]:
        """Every rank's status, after its own synchronize: the failed ranks."""
        import torch
        import torch.distributed as dist

        self._completed = True
        st = torch.tensor([0 if ok else 1], dtype=torch.int64)
        out = [torch.zeros_like(st) for _ in range(self.layout.world)]
        dist.all_gather(out, st, group=self.ctrl)
        return [q for q, t in enumerate(out) if int(t)]

    def _round(self, i: int, slot: int, key, keep: bool) -> list[int]:
        import torch

        from ..config import settings
        from ..crypto.encryption import _host_noise_pairs
        from .sharding import _shard_products

        params, dev, kd = self.params, self.dev, self.layout.kdim
        self.last = None                # this round's rows take the last one's place
        key = torch.tensor(key, dtype=torch.int64)
        sc = _stage("upload", lambda: {r: self.pool[slot][r].to(dev, non_blocking=True)
                                            for r in self.rows})
        host_e1, host_e2 = _host_noise_pairs(params, key, self.d, dev)
        stream = settings.kernel_noise_stream()
        parts = {(r, j): _shard_products(params, *self.ops[(r, j)], sc[r], key, r, j, kd,
                                         self.nl, host_e1, host_e2, False, stream,
                                         self.encode32[slot][r], dev, _stage)
                 for r, j in self.mine}
        del sc
        blocks = self._combine(parts)
        del parts
        return _stage("finish", lambda: self._finish(i, blocks, host_e1, host_e2, keep))

    def _part(self, what: str) -> tuple[int, int, list]:
        """c1's or c2's index in a shard's partials, its rows, and this rank's
        recv rows that hold it (c1: recv row 0 alone)."""
        if what == "c1":
            return 0, self.params.k, [r for r in self.rows if r == 0]
        return 1, self.nl, self.rows

    def _finishes(self, r: int) -> list[int]:
        """The kdim blocks of recv row ``r`` this rank finishes."""
        return [b for b in range(self.layout.kdim) if self.layout.owner(r, b) == self.rank]

    def _combine(self, parts: dict) -> dict:
        """The exact combination of the kdim partials: each block this rank
        finishes, {(what, row, b): (first row, residues)}, from its own
        shards' blocks and the others' (received)."""
        import torch
        import torch.distributed as dist

        from .sharding import _modsum_gathered

        lay, kd, dev = self.layout, self.layout.kdim, self.dev
        sends, recvs, have = {}, {}, {}
        for what in ("c1", "c2"):
            idx, rows, held = self._part(what)
            for r in held:
                mine = [j for rr, j in self.mine if rr == r]
                stored = parts[(r, mine[0])][idx].shape[2]
                tag = lambda j, b: ((idx * lay.recv + r) * kd + j) * kd + b  # noqa: E731
                for j in mine:
                    for b in range(kd):
                        lo, hi = _block(rows, kd, b, stored)
                        blk = parts[(r, j)][idx][:, :, lo:hi]
                        if lay.owner(r, b) == self.rank:
                            have[(what, r, b, j)] = blk
                        elif hi > lo:
                            sends.setdefault(r, []).append((blk, lay.owner(r, b), tag(j, b)))
                for b in self._finishes(r):
                    lo, hi = _block(rows, kd, b, stored)
                    shape = parts[(r, mine[0])][idx][:, :, lo:hi].shape
                    for j in range(kd):
                        if j not in mine and hi > lo:
                            recvs.setdefault(r, []).append(((what, r, b, j), shape,
                                                            lay.owner(r, j), tag(j, b)))
        n_in = sum(8 * torch.Size(s).numel() for rv in recvs.values() for _, s, _, _ in rv)
        n_out = sum(8 * t.numel() for sv in sends.values() for t, _, _ in sv)
        n_ops = sum(map(len, sends.values())) + sum(map(len, recvs.values()))

        def gather():
            got = {}
            for r in sorted(set(sends) | set(recvs)):
                ops = []
                for t, peer, tag in sends.get(r, []):
                    t = t.contiguous()
                    ops.append(dist.P2POp(dist.isend, t.cpu() if self.host else t, peer,
                                          self.row_groups[r], tag))
                for name, shape, peer, tag in recvs.get(r, []):
                    got[name] = torch.empty(shape, dtype=torch.int64,
                                            device="cpu" if self.host else dev)
                    ops.append(dist.P2POp(dist.irecv, got[name], peer, self.row_groups[r], tag))
                for w in dist.batch_isend_irecv(ops):
                    w.wait(self.timeout)
            return {name: t.to(dev) for name, t in got.items()}

        got = _stage("gather", gather, bytes_in=n_in, bytes_out=n_out, transfers=n_ops)
        have.update(got)

        def modsum():
            out = {}
            for what in ("c1", "c2"):
                _, rows, held = self._part(what)
                for r in held:
                    for b in self._finishes(r):
                        lo, hi = _block(rows, kd, b)
                        if hi > lo:
                            out[(what, r, b)] = (lo, _modsum_gathered(
                                [have[(what, r, b, j)] for j in range(kd)],
                                self.params.ring, dev))
            return out

        return _stage("modsum", modsum)

    def _finish(self, i: int, blocks: dict, host_e1, host_e2, keep: bool) -> list[int]:
        """The finished rows of each block (its padding cut, the host noise of
        bounds >= min q added where the shards hold part of k), kept for
        :meth:`collect` with ``keep`` (c2 at :attr:`keep_cols`); then the
        synchronize and the completion collective."""
        from ..ops import u64 as u64op

        q = self.params.ring.table("q", self.dev).reshape(-1, 1, 1, 1)
        out = []
        for (what, r, b), (lo, acc) in sorted(blocks.items()):
            hi = _block(self._part(what)[1], self.layout.kdim, b)[1]
            acc = acc[:, :, :hi - lo]
            host_e, g0 = (host_e1, 0) if what == "c1" else (host_e2, r * self.nl)
            if host_e is not None and self.layout.kdim > 1:
                acc = u64op.addmod(acc, host_e[:, :, g0 + lo:g0 + hi].to(self.dev), q)
            out.append((what, r, lo, acc))
        self.last = (i, out)
        if keep:
            self.kept[i] = self._kept(out)
        self._sync()
        return self._complete(True)

    def _kept(self, blocks: list) -> list:
        cols = self.keep_cols
        return [(what, r, lo, t if what == "c1" or cols is None else t.index_select(3, cols))
                for what, r, lo, t in blocks]

    # -- the rows to judge -----------------------------------------------------

    def collect(self, rounds: list[int]) -> dict:
        """Rank 0: every rank's CRS [world, k, k, L, l], the rows of B [n, k,
        L, l] from each recv row's rank of kdim 0, and of each round in
        ``rounds`` (kept, or the last) c1 [L, l, k, d] and c2 [L, l, n,
        columns] at :attr:`keep_cols`, all on rank 0's device."""
        self._message((COLLECT, len(rounds)))
        self._rounds_asked(len(rounds), rounds)
        return self._collect(rounds)

    def _rounds_asked(self, count: int, rounds=None) -> list[int]:
        import torch
        import torch.distributed as dist

        t = torch.tensor(rounds if rounds is not None else [0] * count, dtype=torch.int64)
        dist.broadcast(t, src=0, group=self.ctrl)
        return t.tolist()

    def _items(self, rank: int, rounds: list[int]):
        """(name, shape) of what ``rank`` sends for :meth:`collect`, in order."""
        p, lay, kd = self.params, self.layout, self.layout.kdim
        L, l = p.ring.num_limbs, p.ring.degree
        ncols = self.d if self.keep_cols is None else len(self.keep_cols)
        items = [(("crs", rank), (p.k, p.k, L, l))]
        rows = sorted({r for r, _ in lay.shards(rank)})
        items += [(("pk", r), (self.nl, p.k, L, l)) for r in rows if lay.owner(r, 0) == rank]
        for i in rounds:
            for what in ("c1", "c2"):
                total = p.k if what == "c1" else self.nl
                for r in rows:
                    if what == "c1" and r != 0:
                        continue
                    for b in range(kd):
                        lo, hi = _block(total, kd, b)
                        if lay.owner(r, b) == rank and hi > lo:
                            items.append(((what, i, r, lo),
                                          (L, l, hi - lo, self.d if what == "c1" else ncols)))
        return items

    def _mine(self, rounds: list[int]) -> dict:
        held = {}
        for i in rounds:
            if i in self.kept:
                blocks = self.kept[i]
            elif self.last is not None and self.last[0] == i:
                blocks = self._kept(self.last[1])
            else:
                raise RuntimeError(f"rank {self.rank} holds no rows of round {i}")
            held.update({(what, i, r, lo): t for what, r, lo, t in blocks})
        held[("crs", self.rank)] = self.crs.matrix.res
        held.update({("pk", r): key.matrix.res for r, key in self.keys.items()})
        return held

    def _collect(self, rounds: list[int]):
        import torch
        import torch.distributed as dist

        held = self._mine(rounds)
        if self.rank:
            for name, _ in self._items(self.rank, rounds):
                t = held[name].contiguous()
                dist.send(t.cpu() if self.host else t, dst=0)
            return None
        p, L, l, dev = self.params, self.params.ring.num_limbs, self.params.ring.degree, self.dev
        ncols = self.d if self.keep_cols is None else len(self.keep_cols)
        crs = torch.empty((self.layout.world, p.k, p.k, L, l), dtype=torch.int64, device=dev)
        pk = torch.empty((p.n, p.k, L, l), dtype=torch.int64, device=dev)
        c1 = {i: torch.empty((L, l, p.k, self.d), dtype=torch.int64, device=dev) for i in rounds}
        c2 = {i: torch.empty((L, l, p.n, ncols), dtype=torch.int64, device=dev) for i in rounds}

        def place(name, t):
            if name[0] == "crs":
                crs[name[1]] = t
            elif name[0] == "pk":
                pk[name[1] * self.nl:(name[1] + 1) * self.nl] = t
            else:
                what, i, r, lo = name
                dst, row0 = (c1[i], lo) if what == "c1" else (c2[i], r * self.nl + lo)
                dst[:, :, row0:row0 + t.shape[2]] = t

        for name, _ in self._items(0, rounds):
            place(name, held[name])
        for src in range(1, self.layout.world):
            for name, shape in self._items(src, rounds):
                buf = torch.empty(shape, dtype=torch.int64, device="cpu" if self.host else dev)
                dist.recv(buf, src=src)
                place(name, buf.to(dev))
        return {"crs": crs, "pk": pk, "rounds": {i: (c1[i], c2[i]) for i in rounds}}


def _stage(name: str, fn, **counts):
    """A stage of a round: ``fn()`` in the span ``pvw.mesh.round.<name>``."""
    from ..utils.profiling import span

    with span(f"pvw.mesh.round.{name}", **counts):
        return fn()


def _stage_ms(records: list) -> dict:
    """{"<stage>_ms": ms} of the ``pvw.mesh.round.<stage>`` spans among
    ``records`` (``profiling.read``), summed by stage: each span's card ms,
    or its host ms without a card."""
    out: dict = {}
    for d in records:
        if d["name"].startswith("pvw.mesh.round."):
            name = d["name"].rpartition(".")[2] + "_ms"
            ms = d["host_ms"] if d["card_ms"] is None else d["card_ms"]
            out[name] = out.get(name, 0.0) + ms
    return out


def _rank_device(rank: int, device: str):
    """``cuda:(rank mod device_count)``, made current, or the CPU."""
    import torch

    from ..utils.device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _served_rank(rank: int, spec: dict, dev) -> MeshRank:
    """Rank ``rank`` of the served mesh ``spec`` (see :class:`MeshService`),
    its inputs made by the caller's function."""
    import torch

    from ..config import settings
    from ..params import PvwParameters

    for name, value in spec["settings"].items():
        setattr(settings, name, value)
    params = PvwParameters.from_dict(spec["params"])
    layout = MeshLayout(spec["world"], 1, KDIM)
    nl = params.n // layout.recv
    rows = {r: (r * nl, (r + 1) * nl) for r, _ in layout.shards(rank)}
    t0 = time.perf_counter()
    inputs = load_inputs(spec["inputs"])(RankView(rank, rows, dev, params, spec["args"]))
    inputs_ms = (time.perf_counter() - t0) * 1e3
    key = lambda w: torch.tensor(w, dtype=torch.int64)  # noqa: E731
    mr = MeshRank(rank, layout, params, dev, key(spec["crs_key"]), key(spec["gen_key"]),
                  inputs["coeffs"], inputs["pool"], inputs.get("keep_cols"))
    mr.setup_ms = {"inputs_ms": inputs_ms, **mr.setup_ms}
    return mr


def _exit_with_parent() -> None:
    """A daemon thread that ends this process once its parent (rank 0) is gone."""
    import threading

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(0.5)
        os._exit(3)

    threading.Thread(target=watch, daemon=True).start()


def serve_rank(rank: int, spec: dict) -> None:
    """A served rank's life (``python -m pvw_tpu_torch.parallel.multiprocess
    serve <rank> <spec JSON>``): its inputs and keys, the store's ready mark,
    the process group, then :meth:`MeshRank.serve` until released."""
    import datetime

    import torch.distributed as dist

    _exit_with_parent()
    dev = _rank_device(rank, spec["device"])
    mr = _served_rank(rank, spec, dev)
    store = dist.TCPStore("127.0.0.1", spec["port"], spec["world"], False,
                          datetime.timedelta(seconds=spec["timeout_s"]))
    store.set(f"ready/{rank}", json.dumps(mr.setup_ms))
    mr.connect(spec["backend"], spec["timeout_s"], store=store)
    try:
        mr.warm_comms()
        mr.serve()
    finally:
        dist.destroy_process_group()


class MeshService:
    """The served (recv, kdim) mesh across ``world`` processes, a shard and
    a device each, from the caller's side: this process is rank 0 on the
    first device (see the module docstring). ``params``: ``PvwParameters``;
    ``crs_key``, ``gen_key``: the CRS's and keygen's keys (key tensors [2]);
    ``inputs``: ``path.py:function``, called on every rank with a
    :class:`RankView` whose ``args`` are ``args`` (JSON), returning
    {"coeffs": {row: int32 [n / recv, k, l]}, "pool": [{row: u64 [d, n /
    recv]}, ...], "keep_cols": dealer columns or absent}; ``settings``:
    ``pvw_tpu_torch.settings`` knobs every rank takes, this process too.
    Raises if a rank exits, or is not ready within :data:`START_S`;
    ``timeout_s`` bounds every transfer (a failed rank fails the round
    within it). Each process builds the kernels it lacks at first use
    (``ops/_build`` renames a whole library into place, so ranks that build
    at once do not race)."""

    def __init__(self, params, crs_key, gen_key, inputs: str, args: dict | None = None, *,
                 world: int = 4, device: str = "cuda", settings: dict | None = None,
                 timeout_s: float = 300.0) -> None:
        import datetime
        import tempfile

        import torch
        import torch.distributed as dist

        t = [time.perf_counter()]
        #: host ms of each set-up step on rank 0, and each other rank's own
        self.setup_ms: dict = {}

        def lap(name):
            t.append(time.perf_counter())
            self.setup_ms[f"{name}_ms"] = (t[-1] - t[-2]) * 1e3

        dev = _rank_device(0, device)
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        backend = choose_backend(dev.type, world, cards)
        MeshLayout(world, 1, KDIM)
        store = dist.TCPStore("127.0.0.1", 0, world, True,
                              datetime.timedelta(seconds=timeout_s), wait_for_workers=False)
        spec = {"world": world, "device": dev.type, "backend": backend,
                "port": store.port, "timeout_s": timeout_s, "params": params.to_dict(),
                "settings": settings or {}, "crs_key": [int(w) for w in crs_key],
                "gen_key": [int(w) for w in gen_key], "inputs": os.path.abspath(
                    inputs.rpartition(":")[0]) + ":" + inputs.rpartition(":")[2],
                "args": args or {}}
        self.procs, self.logs, self.closed, self.broken = [], [], False, None
        cwd = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        try:
            for rank in range(1, world):
                log = tempfile.TemporaryFile("w+")
                self.logs.append(log)
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "pvw_tpu_torch.parallel.multiprocess", "serve",
                     str(rank), json.dumps(spec)], stdout=log, stderr=subprocess.STDOUT,
                    text=True, cwd=cwd))
            lap("spawn")
            self.rank0 = _served_rank(0, spec, dev)
            self.setup_ms["rank0"] = self.rank0.setup_ms
            lap("rank0")
            deadline = time.time() + START_S
            while not store.check([f"ready/{q}" for q in range(1, world)]):
                self._check_ranks()
                if time.time() > deadline:
                    raise RuntimeError(f"mesh ranks not ready within {START_S} s")
                time.sleep(0.05)
            lap("wait_ranks")
            self.setup_ms["ranks"] = {q: json.loads(store.get(f"ready/{q}"))
                                      for q in range(1, world)}
            self.rank0.connect(backend, timeout_s, store=store)
            self.rank0.warm_comms()
            lap("connect")
        except BaseException:
            self._stop(wait_s=0)
            raise
        self.store, self.backend, self.layout = store, backend, self.rank0.layout

    def _check_ranks(self) -> None:
        dead = [(q + 1, p.returncode) for q, p in enumerate(self.procs) if p.poll() is not None]
        if dead:
            raise RuntimeError("mesh rank(s) exited: " + "; ".join(
                f"rank {q} rc={rc}: {self._tail(q)}" for q, rc in dead))

    def _tail(self, rank: int, chars: int = 2000) -> str:
        log = self.logs[rank - 1]
        log.seek(0)
        return log.read()[-chars:]

    def round(self, i: int, slot: int, key, keep: bool = False) -> None:
        """Round ``i`` (:meth:`MeshRank.round`); raises, and leaves the mesh
        unusable, if any rank failed."""
        if self.broken:
            raise RuntimeError(f"the mesh failed earlier: {self.broken}")
        try:
            self._check_ranks()
            self.rank0.round(i, slot, key, keep)
        except Exception as e:
            self.broken = repr(e)
            raise

    def collect(self, rounds) -> dict:
        """:meth:`MeshRank.collect` of ``rounds``."""
        return self.rank0.collect(sorted(rounds))

    def launches(self, reset: bool = False) -> list[dict]:
        """:meth:`MeshRank.launches`."""
        return self.rank0.launches(reset)

    def close(self) -> None:
        """Release the ranks and wait for them (killed if they hang)."""
        if self.closed:
            return
        self.closed = True
        try:
            if self.broken is None:
                self.rank0.release()
        finally:
            self._stop(wait_s=60 if self.broken is None else 0)

    def _stop(self, wait_s: float) -> None:
        """End the process group; wait ``wait_s`` for the ranks, then kill them."""
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        for p in self.procs:
            try:
                p.wait(timeout=wait_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for log in self.logs:
            log.close()
        self.rank0 = None


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


def _worker_inputs(params, dealers: int, layout: MeshLayout, rank: int, device) -> dict:
    """The JAX worker's system (:func:`build_system`) as one rank holds it:
    the secret coefficients of its recv rows' parties alone, and their
    columns of the scalars."""
    import numpy as np
    import torch

    from .. import random as R
    from ..keys import Party

    key, nl = R.key(0), params.n // layout.recv
    rows = sorted({r for r, _ in layout.shards(rank)})
    vectors = np.array([[dd * 10 + r + 1 for r in range(params.n)] for dd in range(dealers)],
                       np.uint64)
    coeffs = {r: torch.from_numpy(np.stack([
        Party.new(i, params, R.fold_in(key, 100 + i), device=device).secret_key.secret_coeffs
        for i in range(r * nl, (r + 1) * nl)]).astype(np.int32)) for r in rows}
    return {"crs_key": R.fold_in(key, 0), "gen_key": R.fold_in(key, 1), "coeffs": coeffs,
            "pool": [{r: vectors[:, r * nl:(r + 1) * nl] for r in rows}]}


def run_worker(rank: int, world: int, port: int, local_devices: int, *, device: str = "cuda",
               params: dict | None = None, dealers: int | None = None,
               stream: str | None = None, backend: str | None = None,
               timeout_s: float = 600.0) -> dict:
    """One rank of the dry run (see the module docstring) on ``params``
    (the dict form; default :func:`default_params`) with ``dealers`` dealers
    (default 8): one round served by :class:`MeshRank`. Raises unless its
    keys' rows, its finished c1 and c2 rows equal its single-device
    encryption byte for byte and its owned dealers decode exactly; prints
    the OK line and the stats line, and returns the stats."""
    import torch
    import torch.distributed as dist

    from ..config import settings
    from ..crypto import device_decode
    from ..crypto.decryption import _contraction, _decode_batch, _noisy_finish
    from ..crypto.encryption import encrypt_batch
    from ..errors import InvalidParameters
    from ..ops import fused_modmat as fm
    from ..params import PvwParameters
    from ..utils import profiling
    from .sharding import _modsum_gathered

    dev = _rank_device(rank, device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev.type, world, cards, backend)
    layout = MeshLayout(world, local_devices, KDIM)
    if stream is not None:
        settings.noise_stream = stream
    params = default_params() if params is None else PvwParameters.from_dict(params)
    if not device_decode.decode_supported(params):
        raise InvalidParameters("the device decode does not cover these parameters")
    d = TEST_DEALERS if dealers is None else dealers
    ring, n, k = params.ring, params.n, params.k
    nr, kd = layout.recv, KDIM
    if n % nr or k % kd or d % nr:
        raise InvalidParameters(f"n={n} and d={d} over recv={nr}, k={k} over kdim={kd}")
    nl, kc, dl = n // nr, k // kd, d // nr
    clock = _Clock(dev)
    mr = clock("system_ms", lambda: MeshRank(rank, layout, params, dev,
                                             **_worker_inputs(params, d, layout, rank, dev)))
    mr.connect(backend, timeout_s, port=port)
    try:
        clock("comm_setup_ms", mr.warm_comms)
        mine, my_rows, groups, host = mr.mine, mr.rows, mr.row_groups, mr.host
        heads = [r for r in my_rows if layout.owner(r, 0) == rank]
        if heads:
            # a head's first decode loads its ops' kernels: on zero residues
            clock("decode_warmup_ms", lambda: _decode_batch(
                torch.zeros((dl, ring.num_limbs, ring.degree), dtype=torch.int64,
                            device=dev), params, "device"))

        # the rank's single-device reference of the whole system (the check's
        # alone); only what it checks is kept
        gpk, parties, vectors, enc_key = clock("reference_system_ms",
                                               lambda: build_system(params, d, dev))
        for r, rows in mr.keys.items():
            if not torch.equal(rows.matrix.res, gpk.matrix.res[r * nl:(r + 1) * nl]):
                raise RuntimeError(f"rank {rank}: the keys of recv row {r} differ from the "
                                   "whole key's rows")
        ct_ref = clock("reference_encrypt_ms", lambda: encrypt_batch(vectors, gpk, enc_key))
        ref = {"c1": ct_ref.c1.channel().cpu(), "c2": ct_ref.c2.channel().cpu()}
        ref_c2_party = ct_ref.c2.channel()[:, :, PARTY].cpu()              # [L, l, d]
        sk = parties[PARTY].secret_key.to_polynomials(dev).res              # [k, L, l]
        del ct_ref, gpk, parties
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)

        for fn, attr in fm.launch_counters().values():
            setattr(fn, attr, 0)
        device_decode.decode_residues.calls = 0
        # the round's stage times from its spans
        settings.trace = True
        profiling.clear()
        try:
            if rank == 0:
                mr.round(0, 0, enc_key)
                mr.release()
            else:
                mr.serve()
        finally:
            del settings.trace
        t = _stage_ms(profiling.read())
        profiling.clear()
        clock.times["sharded_products_ms"] = sum(
            t.get(f"{s}_ms", 0.0) for s in ("upload", "r_stage", "products", "bake"))
        clock.times["gather_modsum_ms"] = sum(
            t.get(f"{s}_ms", 0.0) for s in ("gather", "modsum", "finish"))
        rows_checked = 0
        for what, r, lo, got in mr.last[1]:
            g0 = lo if what == "c1" else r * nl + lo
            if not torch.equal(got.cpu(), ref[what][:, :, g0:g0 + got.shape[2]]):
                raise RuntimeError(f"rank {rank}: {what} rows [{g0}, {g0 + got.shape[2]}) "
                                   "differ from the single-device encryption")
            rows_checked += got.shape[2] if what == "c2" else 0
        mr.last = None

        # decryption across the processes (party 1): the dealers over recv,
        # the k contraction over kdim; each row's head decodes on the device
        c1_ch = ref["c1"].to(dev)

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
            "stream": settings.kernel_noise_stream() or "v3", "device": str(dev),
            "card": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "backend": backend, "transport": "host" if host else "device",
            "cross_process_rows": [r for r in my_rows if groups[r] is not None],
            "rows_checked": rows_checked, "msgs_checked": msgs_checked,
            "launches": counts, "decodes": device_decode.decode_residues.calls,
            "times_ms": {**clock.times, **t},
            "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                        if dev.type == "cuda" else None)}
        dist.barrier(group=mr.ctrl)     # every rank done before the group ends
    finally:
        dist.destroy_process_group()
    print(f"{OK_MARKER} p{rank}/{world}: mesh (recv={nr}, kdim={kd}) over {world} processes x "
          f"{local_devices} devices; encrypt bit-identical ({rows_checked} finished c2 rows + "
          f"recv row 0's c1 rows), sharded device-decode decrypt exact ({msgs_checked} owned "
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
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["serve"]:
        serve_rank(int(argv[1]), json.loads(argv[2]))
        return
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
