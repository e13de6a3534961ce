"""The port's mesh across processes (``pvw_tpu_torch.parallel.multiprocess``)
on the CPU: gloo between real processes at the JAX worker's system (the 4 x
55-bit chain, n = k = 32, d = 8, kdim 2).

Every rank checks its c1 and owned c2 rows against its own single-device
encryption byte for byte and decodes its owned dealers exactly (tolerance
0: residues are canonical), as the JAX package's worker does. That
single-device encryption is held here against ``pvw_tpu.encrypt_batch``
at the same system, byte for byte, which links the ranks' check to the
JAX package.
"""

import sys

import numpy as np
import jax
import pytest
import torch

import pvw_tpu as J
from pvw_tpu.config import settings as jsettings
import pvw_tpu_torch as P
from pvw_tpu_torch import convert
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.errors import InvalidParameters
from pvw_tpu_torch.ops import fused_modmat as fm
from pvw_tpu_torch.parallel import decrypt_party_shares_sharded, make_mesh
from pvw_tpu_torch.parallel import multiprocess as mp


@pytest.mark.parametrize("stream", [None, "v3k"])
@pytest.mark.parametrize("world,local", [(2, 1), (2, 2), (4, 1)])
def test_mesh_across_processes_bit_identical(world, local, stream):
    out = mp.dryrun_multiprocess(world, local, timeout_s=120, device="cpu", stream=stream)
    assert f"{world} processes" in out.summary and "over gloo" in out.summary
    ranks = out.ranks
    assert [r["rank"] for r in ranks] == list(range(world))
    layout = mp.MeshLayout(world, local, mp.KDIM)
    for r in ranks:
        assert r["backend"] == "gloo" and r["transport"] == "host"
        assert r["mesh"] == [layout.recv, mp.KDIM] and r["rows_checked"] > 0
        assert r["stream"] == ("v3k" if stream else "v4")
        # the kdim gather crosses processes exactly where a row spans ranks
        assert r["cross_process_rows"] == [row for row, _ in r["shards"]
                                           if len(layout.row_ranks[row]) > 1][:1]
        assert r["decodes"] == (1 if r["msgs_checked"] else 0)
        assert set(r["launches"]) == set(fm.launch_counters())
    # every dealer decoded once, by its recv row's head
    assert sum(r["msgs_checked"] for r in ranks) == mp.TEST_DEALERS
    assert any(r["cross_process_rows"] for r in ranks) == (local == 1)


def test_mesh_across_processes_takes_the_callers_system():
    """Parameters and a dealer count from the caller reach every rank (the
    dict form on the command line): 4 dealers on a (2, 1) mesh."""
    params = mp.default_params()
    out = mp.dryrun_multiprocess(2, 1, timeout_s=120, device="cpu", params=params, dealers=4)
    assert [(r["n"], r["k"], r["dealers"]) for r in out.ranks] == [(params.n, params.k, 4)] * 2
    assert sum(r["msgs_checked"] for r in out.ranks) == 4
    assert sum(r["decodes"] for r in out.ranks) == 1          # recv row 0's head


@pytest.mark.parametrize("stream", ["kernel", "v3k"])
def test_worker_reference_equals_jax(stream):
    """The ranks' single-device reference, built as the worker builds it,
    equals the JAX worker's ``encrypt_batch`` byte for byte."""
    jp = mp.default_params()
    key = jax.random.key(0)
    jparams = J.PvwParameters.from_dict(jp.to_dict())
    crs = J.PvwCrs.new(jparams, jax.random.fold_in(key, 0))
    parties = [J.Party.new(i, jparams, jax.random.fold_in(key, 100 + i))
               for i in range(jparams.n)]
    jgpk = J.GlobalPublicKey(crs)
    jgpk.generate_all_party_keys(parties, jax.random.fold_in(key, 1))
    vectors = np.array([[dd * 10 + r + 1 for r in range(jparams.n)]
                        for dd in range(mp.TEST_DEALERS)], np.uint64)
    gpk, tparties, tvectors, enc_key = mp.build_system(jp, mp.TEST_DEALERS, "cpu")
    np.testing.assert_array_equal(tvectors, vectors)
    np.testing.assert_array_equal(gpk.matrix.residues_np(), jgpk.matrix.residues_np())
    np.testing.assert_array_equal(convert.key_from_words(
        np.asarray(jax.random.key_data(jax.random.fold_in(key, 5)))).numpy(), enc_key.numpy())
    jsettings.noise_stream = tsettings.noise_stream = stream
    try:
        jct = J.encrypt_batch(vectors, jgpk, jax.random.fold_in(key, 5))
        tct = P.encrypt_batch(tvectors, gpk, enc_key)
    finally:
        del jsettings.noise_stream, tsettings.noise_stream
    np.testing.assert_array_equal(tct.c1.residues_np(), jct.c1.residues_np())
    np.testing.assert_array_equal(tct.c2.residues_np(), jct.c2.residues_np())
    one = make_mesh([torch.device("cpu")], kdim=1)
    assert decrypt_party_shares_sharded(tct, tparties[mp.PARTY].secret_key, mp.PARTY, one) == \
        [int(v) for v in vectors[:, mp.PARTY]]


def test_worker_dying_early_fails_the_launch(monkeypatch):
    """A worker that exits before the group forms: the launcher kills the
    others, retries on a fresh port, then raises naming the worker."""
    real = mp._worker_command

    def dies_at_rank_1(rank, *rest):
        if rank == 1:
            return [sys.executable, "-c", "import sys; sys.exit(3)"]
        return real(rank, *rest)

    monkeypatch.setattr(mp, "_worker_command", dies_at_rank_1)
    with pytest.raises(RuntimeError, match="worker died early") as e:
        mp.dryrun_multiprocess(2, 1, timeout_s=120, attempts=2, device="cpu")
    msg = str(e.value)
    assert "attempt 2/2" in msg and "worker 1: rc=3" in msg and "worker 0: rc=" in msg


def test_backend_follows_the_topology():
    assert mp.choose_backend("cpu", 4, 0) == "gloo"
    assert mp.choose_backend("cuda", 4, 1) == "gloo"          # ranks share the card
    assert mp.choose_backend("cuda", 4, 4) == "nccl"          # a card a rank
    assert mp.choose_backend("cuda", 2, 4, "gloo") == "gloo"
    with pytest.raises(InvalidParameters, match="nccl needs a card for every rank"):
        mp.choose_backend("cuda", 4, 1, "nccl")
    with pytest.raises(InvalidParameters, match="nccl"):
        mp.choose_backend("cpu", 2, 0, "nccl")
    with pytest.raises(InvalidParameters, match="backend"):
        mp.choose_backend("cpu", 2, 0, "mpi")


def test_mesh_layout_is_rank_major():
    lay = mp.MeshLayout(4, 1, 2)
    assert (lay.recv, lay.row_ranks) == (2, [[0, 1], [2, 3]])
    assert [lay.shards(r) for r in range(4)] == [[(0, 0)], [(0, 1)], [(1, 0)], [(1, 1)]]
    lay = mp.MeshLayout(2, 2, 2)
    assert lay.row_ranks == [[0], [1]] and lay.shards(1) == [(1, 0), (1, 1)]
    lay = mp.MeshLayout(2, 2, 4)
    assert lay.row_ranks == [[0, 1]] and lay.owner(0, 3) == 1
    with pytest.raises(InvalidParameters):
        mp.MeshLayout(3, 1, 2)
    with pytest.raises(InvalidParameters):
        mp.MeshLayout(2, 3, 2)


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mp.dryrun_multiprocess(2, 1)
