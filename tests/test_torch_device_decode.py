"""The port's device decode against the JAX package's, on the CPU.

``pvw_tpu_torch.ops.mw`` (multiword magnitudes in int64 lanes) against
``pvw_tpu.ops.mw`` and Python ints; ``pvw_tpu_torch.crypto.device_decode.
decode_residues`` against the JAX package's ``decode_residues`` and its
oracle ``decode_scalar_pvw_rns`` on every message of four chains (the toy
chain, config 4's 17 x 61-bit chain at l = 16 with its 65-bit Δ, the
reference preset's 4 x 55-bit chain, and one 36-bit limb, where q < 2^64
makes the small-negative clamp visible) with the decode's edge rows; the
``PVW_TPU_DECODE`` routing; and the sharded, limb-parallel and grid
decryptions, each decoding in its shards. Tolerance 0 everywhere.
"""

import contextlib
from types import SimpleNamespace

import numpy as np
import jax
import pytest
import torch

import pvw_tpu as J
import pvw_tpu.parallel as JP
from pvw_tpu.crypto import device_decode as jdd
from pvw_tpu.crypto.decryption import decode_scalar_pvw_rns
from pvw_tpu.config import settings as jsettings
from pvw_tpu.ops import mw as jmw, u64 as ju64
from pvw_tpu.utils.intmath import generate_ntt_primes
import pvw_tpu_torch as P
import pvw_tpu_torch.parallel as TP
from pvw_tpu_torch import convert
from pvw_tpu_torch.config import settings as tsettings
from pvw_tpu_torch.crypto import decryption as tdec, device_decode as tdd
from pvw_tpu_torch.ops import mw, u64

CPU = torch.device("cpu")


def rand_int(rng, bits: int) -> int:
    return int.from_bytes(rng.bytes((bits + 7) // 8), "little") % (1 << bits)


# --------------------------------------------------------------------------
# ops/mw.py against pvw_tpu.ops.mw and Python ints
# --------------------------------------------------------------------------

def magnitudes(rng, nw: int, count: int = 16) -> list:
    """Random values below 2^(32 nw), with all-ones words among them."""
    top = (1 << (32 * nw)) - 1
    vals = [rand_int(rng, 32 * nw) for _ in range(count - 4)]
    ones_low = (1 << (32 * (nw // 2 + 1))) - 1           # a run of all-ones words
    return vals + [top, 0, ones_low, top ^ 0xFFFFFFFF]


def both(vals, nw):
    """(port int64 tensor, JAX uint32 words) of the values [len, nw]."""
    words = np.stack([mw.words_from_int(v, nw) for v in vals])
    return torch.from_numpy(words), words.astype(np.uint32)


def ints(words) -> list:
    return [mw.int_from_words(w) for w in np.asarray(words).astype(np.int64)]


def assert_words_equal(got: torch.Tensor, want_jax) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jax).astype(np.int64))


@pytest.mark.parametrize("nw", [3, 9, 33])
@pytest.mark.parametrize("op", ["add", "sub", "compare", "select", "mul_static",
                                "div_by_static", "mod_by_static"])
def test_mw_equals_jax(nw, op):
    rng = np.random.default_rng(nw * 7 + len(op))
    xs, ys = magnitudes(rng, nw), magnitudes(rng, nw)[::-1]
    ys[1] = xs[1]                                        # an equal pair
    top = 1 << (32 * nw)
    x, jx = both(xs, nw)
    y, jy = both(ys, nw)
    if op == "add":
        got = mw.mag_add(x, y)
        assert_words_equal(got, jmw.mag_add(jx, jy))
        assert ints(got) == [(a + b) % top for a, b in zip(xs, ys)]
    elif op == "sub":
        got, borrow = mw.mag_sub_borrow(x, y)
        jgot, jborrow = jmw.mag_sub_borrow(jx, jy)
        assert_words_equal(got, jgot)
        assert borrow.tolist() == np.asarray(jborrow).tolist() == [a < b for a, b in zip(xs, ys)]
        assert ints(got) == [(a - b) % top for a, b in zip(xs, ys)]
        big = mw.mag_select(mw.mag_ge(x, y), x, y)
        small = mw.mag_select(mw.mag_ge(x, y), y, x)
        assert ints(mw.mag_sub(big, small)) == [abs(a - b) for a, b in zip(xs, ys)]
    elif op == "compare":
        for port, jaxf, want in ((mw.mag_ge, jmw.mag_ge, [a >= b for a, b in zip(xs, ys)]),
                                 (mw.mag_gt, jmw.mag_gt, [a > b for a, b in zip(xs, ys)])):
            assert port(x, y).tolist() == np.asarray(jaxf(jx, jy)).tolist() == want
        assert mw.mag_is_zero(x).tolist() == np.asarray(jmw.mag_is_zero(jx)).tolist() \
            == [a == 0 for a in xs]
    elif op == "select":
        pred = np.array([v % 3 == 0 for v in xs])
        got = mw.mag_select(torch.from_numpy(pred), x, y)
        assert_words_equal(got, jmw.mag_select(pred, jx, jy))
        m = mw.words_from_int(ys[0], nw)
        assert_words_equal(mw.mag_cond_sub(x, m), jmw.mag_cond_sub(jx, m.astype(np.uint32)))
        assert_words_equal(mw.mag_inc(x, torch.from_numpy(pred)), jmw.mag_inc(jx, pred))
    elif op == "mul_static":
        for cbits in (31, 64, 32 * nw):
            c = rand_int(rng, cbits) | 1 << (cbits - 1)
            cw = mw.words_from_int(c, mw.nw_for_bits(cbits))
            got = mw.mag_mul_static(x, cw)
            assert_words_equal(got, jmw.mag_mul_static(jx, cw.astype(np.uint32)))
            assert ints(got) == [a * c for a in xs]
        yh, yl = (rng.integers(0, 1 << 32, len(xs), dtype=np.uint64) for _ in range(2))
        yh[0] = yl[0] = 0xFFFFFFFF
        got = mw.mag_mul_u64pair(x, torch.from_numpy(yh.astype(np.int64)),
                                 torch.from_numpy(yl.astype(np.int64)))
        assert_words_equal(got, jmw.mag_mul_u64pair(jx, yh.astype(np.uint32),
                                                    yl.astype(np.uint32)))
    else:
        # divisors below one word and about half the width; the inputs reach
        # the plan's max_value and the largest it admits (all ones at its
        # input width; the quotient then comes back mod 2^(32 nw_q))
        for dbits in (29, 16 * nw + 5):
            d = rand_int(rng, dbits) | 1 << (dbits - 1) | 1
            plan, jplan = mw.StaticDivisor(d, top - 1), jmw.StaticDivisor(d, top - 1)
            nw_in = plan.nw_in
            vals = xs + [(1 << (32 * nw_in)) - 1, top - 1, d * (top // d) - 1, d]
            xin, jxin = both(vals, nw_in)
            if op == "div_by_static":
                got = mw.div_by_static(xin, plan)
                assert_words_equal(got, jmw.div_by_static(jxin, jplan))
                assert ints(got) == [v // d % (1 << (32 * plan.nw_q)) for v in vals]
            else:
                got = mw.mod_by_static(xin, plan)
                assert_words_equal(got, jmw.mod_by_static(jxin, jplan))
                assert ints(got) == [v % d for v in vals]


def test_mw_accumulator_equals_jax():
    """The accumulator (one int64 lane a position here, a carry-save pair
    in the JAX package) resolves to the same words at its load bound: the
    16-bit-half sums of 2^15 rows of words, then whole words."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, size=(4, 1 << 15, 9), dtype=np.uint64)
    words[0] = 0xFFFFFFFF
    lo, hi = (words & 0xFFFF).sum(1), (words >> 16).sum(1)        # each < 2^31
    acc = mw.acc_add_sum32(mw.acc_zero((4,), 12), torch.from_numpy(lo.astype(np.int64)),
                           torch.from_numpy(hi.astype(np.int64)), 2)
    acc = mw.acc_add_u32(acc, torch.from_numpy(words[:, 0].astype(np.int64)), 3)
    jacc = jmw.acc_add_sum32(jmw.acc_zero((4,), 12), lo.astype(np.uint32),
                             hi.astype(np.uint32), 2)
    jacc = jmw.acc_add_u32(jacc, words[:, 0].astype(np.uint32), 3)
    for nw_out in (12, 14, 5):
        got = mw.acc_propagate(acc, nw_out)
        assert_words_equal(got, jmw.acc_propagate(jacc, nw_out))
        want = [((sum(mw.int_from_words(w) for w in words[r].astype(np.int64)) << 64)
                 + (mw.int_from_words(words[r, 0].astype(np.int64)) << 96))
                % (1 << (32 * nw_out)) for r in range(4)]
        assert ints(got) == want


# --------------------------------------------------------------------------
# decode_residues against JAX decode_residues and decode_scalar_pvw_rns
# --------------------------------------------------------------------------

CHAINS = {
    "toy": ((0xFFFFC4001, 0x1FFFFE0001), 8),
    "config4": (tuple(generate_ntt_primes(61, 17, 16)), 16),
    "reference": (tuple(generate_ntt_primes(55, 4, 8)), 8),
    "one_limb": ((0xFFFFC4001,), 8),
}
ROWS = 64


def jax_params(moduli, l, n=4, k=16):
    b1, b2 = J.PvwParameters.suggest_error_bounds(n, k, l, moduli, 0.5)
    return (J.PvwParametersBuilder().set_parties(n).set_dimension(k).set_l(l)
            .set_moduli(moduli).set_secret_variance(0.5).set_error_bounds_u32(b1, b2)
            .build())


def encoding(v: int, delta: int, q: int, l: int, noise) -> list:
    """Coefficients z_j = -(v * Δ^j + e_j) mod q: what <s, c1> - c2 leaves
    for a message v with noise e; the decode gives v back (mod q, clamped)."""
    return [(-(v * delta ** j + int(noise[j]))) % q for j in range(l)]


def edge_batch(jp):
    """ROWS residue blocks uint64 [ROWS, L, l] and the row indices of each
    edge: coefficients that lift to q//2 and q//2 + 1 (the strict centering),
    messages v = ±1000 and ±1001 (the clamp of small negatives), v = 2^64
    and 2^64 + 12345 (past u64), 2^64 - 1 and noisy random u64 messages, a
    zero row, the JAX test's boundary values, and uniform residues."""
    ring, l = jp.ring, jp.l
    q, delta, dpow = jp.q_total(), jp.delta(), jp.delta_power_l_minus_1()
    rng = np.random.default_rng(len(ring.moduli) * 100 + l)
    coeffs, names = [], {}

    def add(name, cs):
        names.setdefault(name, []).append(len(coeffs))
        coeffs.append(cs)

    add("q_half", [q // 2] * l)
    add("q_half_plus_1", [q // 2 + 1] * l)
    add("q_half", [q // 2 if j % 2 else q // 2 + 1 for j in range(l)])
    zero = np.zeros(l, np.int64)
    small = rng.integers(-(delta // 4), delta // 4 + 1, size=l)
    add("q_half", encoding(q // 2, delta, q, l, zero))
    add("q_half_plus_1", encoding(q // 2 + 1, delta, q, l, zero))
    for v in (-1000, 1000):
        add("clamp_1000", encoding(v % q, delta, q, l, zero))
        add("clamp_1000", encoding(v % q, delta, q, l, small))
    for v in (-1001, 1001):
        add("clamp_1001", encoding(v % q, delta, q, l, zero))
        add("clamp_1001", encoding(v % q, delta, q, l, small))
    for v in (1 << 64, (1 << 64) + 12345, (1 << 65) + 1):
        add("above_u64", encoding(v % q, delta, q, l, zero))
        add("above_u64", encoding(v % q, delta, q, l, small))
    add("zero_row", [0] * l)
    for v in [(1 << 64) - 1, 0, 1] + [int(x) for x in rng.integers(0, 1 << 63, 6)]:
        add("messages", encoding(v % q, delta, q, l,
                                 rng.integers(-(delta // 4), delta // 4 + 1, size=l)))
    specials = [1, 2, q - 1, q - 2, q // 2 - 1, 500, 999, q - 999, delta, delta - 1,
                delta + 1, 2 * delta, q - delta, dpow % q, (dpow // 2) % q,
                (dpow // 2 + 1) % q, (q - dpow) % q, (1 << 64) % q, (delta // 2) % q,
                (3 * delta // 2) % q, (q - delta // 2) % q]
    for v in specials:
        add("boundaries", [(v * (j + 1) + j) % q for j in range(l)])
    res = np.stack([rng.integers(0, m, size=(ROWS, l), dtype=np.uint64)
                    for m in ring.moduli], 1)
    for r, cs in enumerate(coeffs):
        res[r] = ring.residues_from_int_coeffs(cs)
    names["uniform"] = list(range(len(coeffs), ROWS))
    assert len(coeffs) < ROWS
    return res, names


@pytest.fixture(scope="module", params=list(CHAINS))
def decoded(request):
    """One chain's edge batch decoded three ways: the port (CPU tensors),
    JAX ``decode_residues`` and the oracle ``decode_scalar_pvw_rns``."""
    moduli, l = CHAINS[request.param]
    jp = jax_params(moduli, l)
    tp = convert.params_from_dict(jp.to_dict())
    res, names = edge_batch(jp)
    before = tdd.decode_residues.calls
    port = u64.u64_numpy(tdd.decode_residues(tdd.get_plan(tp), u64.u64_tensor(res)))
    assert tdd.decode_residues.calls == before + 1
    args = (jdd.get_plan(jp), *ju64.split_u64_np(res))
    if len(moduli) > 4:                  # config 4 compiles slower than it runs op by op
        with jax.disable_jit():
            out = np.asarray(jdd.decode_residues(*args))
    else:
        out = np.asarray(jdd.decode_residues_jit(*args))
    jx = (out[0].astype(np.uint64) << np.uint64(32)) | out[1].astype(np.uint64)
    return SimpleNamespace(
        name=request.param, jp=jp, q=jp.q_total(), names=names,
        port=[int(v) for v in port], jax=[int(v) for v in jx],
        oracle=[decode_scalar_pvw_rns(res[i], jp) for i in range(ROWS)])


def test_decode_equals_jax_and_oracle(decoded):
    """Every message of the batch, tolerance 0; config 4's Δ has 65 bits."""
    if decoded.name == "config4":
        assert decoded.jp.delta().bit_length() == 65
        assert tdd.get_plan(convert.params_from_dict(decoded.jp.to_dict())).W == 33
    assert tdd.decode_supported(convert.params_from_dict(decoded.jp.to_dict()))
    assert decoded.port == decoded.jax == decoded.oracle


@pytest.mark.parametrize("edge", ["q_half", "q_half_plus_1", "clamp_1000", "clamp_1001",
                                  "above_u64", "zero_row", "messages"])
def test_decode_edges(decoded, edge):
    rows = decoded.names[edge]
    got = [decoded.port[r] for r in rows]
    assert got == [decoded.jax[r] for r in rows] == [decoded.oracle[r] for r in rows]
    q = decoded.q
    if edge == "clamp_1000":                              # -1000 -> 0, +1000 kept
        assert got == [0, 0, 1000, 1000]
    elif edge == "clamp_1001":                            # -1001 wraps to q - 1001
        wrapped = q - 1001 if q - 1001 < 1 << 64 else 0
        assert got == [wrapped, wrapped, 1001, 1001]
    elif edge == "above_u64" and q > 1 << 66:
        assert got == [0] * 6
    elif edge == "zero_row":
        assert got == [0]
    elif edge == "messages" and q > 1 << 66:
        assert got[:3] == [(1 << 64) - 1, 0, 1]


# --------------------------------------------------------------------------
# the routing (PVW_TPU_DECODE)
# --------------------------------------------------------------------------

MODULI4 = tuple(generate_ntt_primes(55, 4, 8))


class System:
    """A tiny JAX system (n = k = 8, 4 x 55-bit) and the port's copy."""

    def __init__(self, seed=3):
        self.jp = jax_params(MODULI4, 8, n=8, k=8)
        key = jax.random.key(seed)
        crs = J.PvwCrs.new(self.jp, jax.random.fold_in(key, 0))
        self.jparties = [J.Party.new(i, self.jp, jax.random.fold_in(key, 100 + i))
                         for i in range(8)]
        self.jgpk = J.GlobalPublicKey(crs)
        self.jgpk.generate_all_party_keys(self.jparties, jax.random.fold_in(key, 1))
        self.tp = convert.params_from_dict(self.jp.to_dict())
        self.tgpk = convert.global_pk_from_residues(
            self.jgpk.matrix.residues_np(),
            convert.crs_from_residues(crs.matrix.residues_np(), self.tp, device="cpu"))
        self.key = jax.random.fold_in(key, 5)
        self.tkey = convert.key_from_words(np.asarray(jax.random.key_data(self.key)))
        # 4 dealers for the backends, n = 8 for the batched entry points
        self.sc = np.random.default_rng(seed).integers(0, 1 << 32, (4, 8), dtype=np.uint64)
        self.sc8 = np.random.default_rng(seed + 1).integers(0, 1 << 32, (8, 8),
                                                            dtype=np.uint64)

    def tsk(self, i):
        return convert.secret_key_from_coeffs(self.jparties[i].secret_key.secret_coeffs,
                                              self.tp)

    def jsk(self, i):
        return self.jparties[i].secret_key


@pytest.fixture(scope="module")
def system():
    return System()


@contextlib.contextmanager
def decode_mode(mode):
    tsettings.decode_mode = mode
    try:
        yield
    finally:
        del tsettings.decode_mode


@contextlib.contextmanager
def no_host_decode(monkeypatch):
    """Fail if the Python decode runs."""
    def refuse(*a, **k):
        raise AssertionError("the host decode ran")

    with monkeypatch.context() as m:
        m.setattr(tdec, "decode_scalar_pvw_rns", refuse)
        yield


@pytest.mark.parametrize("mode", ["auto", "device", "python", "host", "native"])
@pytest.mark.parametrize("entry", ["shares", "value", "threshold"])
def test_decode_mode_routing(system, mode, entry, monkeypatch):
    """Each mode decodes with its engine, as the JAX package routes it:
    ``auto`` sends these batches (8, 1 and 4 messages, below the crossover)
    to the host engine, ``device`` to the device decode (``decode_residues``
    once a call), ``host`` and ``native`` to the C++ engine (the whole
    decryption, or the decode of the device's residues), ``python`` to the
    Python decode; only ``python`` runs the Python decode."""
    sc = system.sc8
    ct = P.encrypt_batch(sc, system.tgpk, system.tkey)
    party = 3
    calls = {
        "shares": lambda: P.decrypt_party_shares(ct, system.tsk(party), party),
        "value": lambda: P.decrypt_party_value(P.encrypt(sc[1], system.tgpk, system.tkey),
                                               system.tsk(party), party),
        "threshold": lambda: [s for _, s in P.decrypt_valid_shares(
            ct, [0, 2, 3, 7], 3, system.tsk(party), party)],
    }
    want = {"shares": [int(v) for v in sc[:, party]], "value": int(sc[1, party]),
            "threshold": [int(sc[i, party]) for i in (0, 2, 3, 7)]}
    engine = {"auto": "host"}.get(mode, mode)
    before = (tdd.decode_residues.calls, dict(vars(tdec.engine_calls)))
    with decode_mode(mode):
        with no_host_decode(monkeypatch) if mode != "python" else contextlib.nullcontext():
            got = calls[entry]()
    assert got == want[entry]
    assert tdd.decode_residues.calls - before[0] == (engine == "device")
    assert {e: c - before[1][e] for e, c in vars(tdec.engine_calls).items()} == \
        {e: int(e == engine) for e in before[1]}


def unsupported_params():
    """A 36-bit q at l = 64: Δ = 1, which the device decode does not cover."""
    return (P.PvwParametersBuilder().set_parties(4).set_dimension(8).set_l(64)
            .set_moduli((0xFFFFC4001,)).set_secret_variance(0.5)
            .set_error_bounds_u32(1, 1).build())


def test_unsupported_parameters_fall_back_counted_or_raise():
    """Where ``decode_supported`` is False, ``auto`` and ``device`` decode
    with the C++ engine, as the JAX package routes them; without it
    (``no_native``) the Python decode runs, counted in
    ``_decode_mode.python_fallbacks``."""
    p = unsupported_params()
    assert p.delta() == 1 and not tdd.decode_supported(p)
    rng = np.random.default_rng(2)
    res = rng.integers(0, 0xFFFFC4001, size=(3, 1, 64), dtype=np.uint64)
    z = u64.u64_tensor(res)
    want = [tdec.decode_scalar_pvw_rns(r, p) for r in res]
    for mode in ("auto", "device"):
        before = (tdd.decode_residues.calls, tdec._decode_mode.python_fallbacks,
                  tdec.engine_calls.native)
        with decode_mode(mode):
            assert tdec._decode_mode(p) == "native"
            assert tdec._decode_batch(z, p) == want
        assert (tdd.decode_residues.calls, tdec._decode_mode.python_fallbacks,
                tdec.engine_calls.native) == (before[0], before[1], before[2] + 1)
    tsettings.no_native = True
    try:
        before = tdec._decode_mode.python_fallbacks
        assert tdec._decode_batch(z, p) == want
        assert tdec._decode_mode.python_fallbacks == before + 1
    finally:
        del tsettings.no_native
    with pytest.raises(ValueError, match="does not cover"):
        tdd.decode_residues(tdd.get_plan(p), z)


def test_plan_tables_uploaded_once(system):
    """A plan's tables reach a device once; later decodes reuse them."""
    plan = tdd.get_plan(system.tp)
    assert plan is tdd.get_plan(convert.params_from_dict(system.jp.to_dict()))
    t = plan.tables(CPU)
    assert plan.tables("cpu") is t
    assert plan.div2d.words(CPU) is plan.div2d.words("cpu")


# --------------------------------------------------------------------------
# the decode inside the shards
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sharded_shares(system):
    """The JAX package's decryption of the 4-dealer batch for party 5 over
    its (2, 2) mesh. It decodes with its oracle here: its device decode
    inside a shard_map takes most of a minute to compile on the CPU, and
    ``tests/test_sharding.py`` holds the two equal; its limb-parallel and
    grid decryptions are held to the single-device one there too."""
    jct = J.encrypt_batch(system.sc, system.jgpk, system.key)
    jsettings.decode_mode = "python"
    try:
        return JP.decrypt_party_shares_sharded(jct, system.jsk(5), 5,
                                               JP.make_mesh(jax.devices()[:4], kdim=2))
    finally:
        del jsettings.decode_mode


@pytest.mark.parametrize("backend,decodes", [("sharded", 2), ("sharded_kdim1", 4),
                                             ("limb_parallel", 1), ("grid", 2)])
def test_backend_decrypt_decodes_in_shards(system, jax_sharded_shares, backend, decodes,
                                           monkeypatch):
    """The sharded ((2, 2) and (4, 1) meshes: a decode per recv row),
    limb-parallel (the limbs gathered on the first shard's device: one
    decode) and grid (2 limb groups x (2, 1): a decode per dealer block)
    decryptions of 4 dealers equal the JAX package's, with no host decode;
    under ``python`` they decode on the host and agree."""
    sc, party = system.sc, 5
    if backend.startswith("sharded"):
        ct = P.encrypt_batch(sc, system.tgpk, system.tkey)
        mesh = TP.make_mesh([CPU] * 4, kdim=2 if backend == "sharded" else 1)
        run = lambda: TP.decrypt_party_shares_sharded(ct, system.tsk(party), party, mesh)  # noqa: E731
    elif backend == "limb_parallel":
        ct = TP.encrypt_batch_limb_parallel(sc, system.tgpk, system.tkey, [CPU] * 2)
        run = lambda: TP.decrypt_party_shares_limb_parallel(ct, system.tsk(party), party)  # noqa: E731
    else:
        ct = TP.encrypt_batch_grid(sc, system.tgpk, system.tkey, [CPU] * 4, limb_groups=2,
                                   kdim=1)
        run = lambda: TP.decrypt_party_shares_grid(ct, system.tsk(party), party)  # noqa: E731
    before = tdd.decode_residues.calls
    with no_host_decode(monkeypatch):
        got = run()
    assert tdd.decode_residues.calls - before == decodes
    assert got == jax_sharded_shares == [int(v) for v in sc[:, party]]
    with decode_mode("python"):
        assert run() == got
    assert tdd.decode_residues.calls - before == decodes
