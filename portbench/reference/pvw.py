"""A plain reference of PVW encryption and decryption, in PyTorch integer ops.

It imports nothing of the program: the threefry streams, the samplers, the
negacyclic NTT, the products over R_q and the decode are written out here
from the scheme's definition and the program's published stream contracts
(threefry-2x32-20 with JAX's key semantics; the row-keyed bounded-uniform
stream; the draws of r and of the noise of each ``noise_stream`` in
``streams/<name>.py``). Residues are int64
tensors in [0, q). Every product mod q is exact: operands are split into
21-bit digits whose products, summed over at most 2048 terms, stay below
2^53 and so are exact in a float64 matmul; the digit sums are recombined
by doublings mod q (q < 2^62, so 2x never overflows).
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
DIGIT_BITS = 21
DIGIT_MASK = (1 << DIGIT_BITS) - 1


# --------------------------------------------------------------------------
# threefry-2x32-20 and keys (jax.random semantics, partitionable)
# --------------------------------------------------------------------------

def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on int64 words below 2^32."""
    ks2 = k0 ^ k1 ^ _PARITY
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    sched = ((k1, ks2, 1), (ks2, k0, 2), (k0, k1, 3), (k1, ks2, 4), (ks2, k0, 5))
    for i, (ka, kb, inc) in enumerate(sched):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ka) & M32
        x1 = (x1 + kb + inc) & M32
    return x0, x1


def key(seed: int, device="cpu") -> torch.Tensor:
    """The key of an integer seed in [0, 2^64): words (seed >> 32, low 32 bits)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed {seed} outside [0, 2^64)")
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """Key(s) [..., 2] from ``k`` and integer data (one key per element)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=k.device) & M32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    return fold_in(k, torch.arange(num, dtype=torch.int64, device=k.device))


def words_at(k: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Word ``idx`` of the stream of key(s) ``k`` [..., 2] (broadcast
    against ``idx``): y0 ^ y1 of threefry(k, (idx >> 32, idx & M32))."""
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], idx >> 32, idx & M32)
    return y0 ^ y1


def reduce96(w_hi, w_mid, w_lo, rng: int):
    """floor((w_hi 2^64 + w_mid 2^32 + w_lo) * rng / 2^96), rng < 2^31."""
    t = (w_lo * rng) >> 32
    t = (w_mid * rng + t) >> 32
    return (w_hi * rng + t) >> 32


def reduce128(w, rng: int):
    """floor(X * rng / 2^128) for X = w[0] 2^96 + w[1] 2^64 + w[2] 2^32 + w[3]
    and rng < 2^62: the product's 32-bit columns with carries."""
    r_lo, r_hi = rng & M32, rng >> 32
    cols = [0] * 7
    for t in range(4):
        p = 3 - t                                  # 2^(32 p) is word t's weight
        lo = w[t] * r_lo                           # < 2^64: wraps, the bits stay
        hi = w[t] * r_hi                           # < 2^62
        cols[p] = cols[p] + (lo & M32)
        cols[p + 1] = cols[p + 1] + ((lo >> 32) & M32) + (hi & M32)
        cols[p + 2] = cols[p + 2] + (hi >> 32)
    carry, out = 0, []
    for p in range(7):
        v = cols[p] + carry
        out.append(v & M32)
        carry = v >> 32
    return out[4] | (out[5] << 32)


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------

def popcount32(x):
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & M32) >> 24


def cbd_from_words(w0, w1, variance: float):
    """Centered binomial of two 32-bit words: b1 - b2 at variance 0.5, else
    the popcount of 2v bits minus the popcount of the next 2v bits."""
    if abs(float(variance) - 0.5) < 1e-6:
        return (w0 & 1) - (w1 & 1)
    two_v = 2 * int(variance)
    mask = (1 << two_v) - 1 if two_v < 32 else M32
    add = popcount32(w0 & mask)
    if 2 * two_v <= 32:
        return add - popcount32((w0 >> two_v) & mask)
    low = 32 - two_v
    return add - popcount32(w0 >> two_v) - popcount32(w1 & ((1 << (two_v - low)) - 1))


def uniform_mod_q(k: torch.Tensor, shape, moduli, device) -> torch.Tensor:
    """Uniform residues [*shape[:-1], L, l] (``shape`` ends with l): limb i from
    fold_in(k, i), word index (flat, 4 words a value), 128-bit reduction."""
    shape = tuple(shape)
    n = math.prod(shape)
    idx = torch.arange(n * 4, dtype=torch.int64, device=device).reshape(n, 4)
    out = []
    for i, q in enumerate(moduli):
        w = words_at(fold_in(k.to(device), i), idx)
        out.append(reduce128([w[:, t] for t in range(4)], int(q)).reshape(shape))
    return torch.stack(out, dim=-2)


def row_uniform(k: torch.Tensor, rows, cols, l: int, bound: int):
    """The row-keyed bounded-uniform stream: row g from fold_in(k, g), value
    (c, j) of the row from words ((c*l + j)*3 + t), t = 0, 1, 2, reduced to
    [-bound, bound]. rows, cols: int64 global indices -> int64 [R, C, l]."""
    rng = 2 * int(bound) + 1
    if rng >= 1 << 30:
        raise ValueError("bound beyond the 96-bit draw")
    keys = fold_in(k.to(rows.device), rows)                           # [R, 2]
    base = ((cols[:, None] * l + torch.arange(l, device=rows.device)) * 3).reshape(-1)
    w = [words_at(keys, base + t) for t in range(3)]                  # [R, C*l]
    return (reduce96(w[0], w[1], w[2], rng) - bound).reshape(len(rows), len(cols), l)


# --------------------------------------------------------------------------
# exact arithmetic mod q
# --------------------------------------------------------------------------

def _digits(x):
    return [(x >> (DIGIT_BITS * u)) & DIGIT_MASK for u in range(3)]


def _recombine(terms, q):
    """sum_s terms[s] 2^(21 s) mod q, terms int64 >= 0."""
    acc = torch.remainder(terms[-1], q)
    for t in reversed(terms[:-1]):
        for _ in range(DIGIT_BITS):
            acc = acc + acc
            acc = torch.where(acc >= q, acc - q, acc)
        acc = acc + torch.remainder(t, q)
        acc = torch.where(acc >= q, acc - q, acc)
    return acc


def mulmod(a, b, q):
    """a * b mod q elementwise (broadcasting), residues below q < 2^62."""
    da, db = _digits(a), _digits(b)
    terms = [sum(da[u] * db[s - u] for u in range(3) if 0 <= s - u < 3) for s in range(5)]
    return _recombine(terms, q)


def matmul_mod(x, y, q, chunk_bytes: int = 1 << 30):
    """x [C, M, K] @ y [C, K, N] mod q [C] (residues below q < 2^62, K <= 2048),
    in blocks of channels whose output holds about ``chunk_bytes``."""
    C, M, K = x.shape
    N = y.shape[-1]
    if K > 2048:
        raise ValueError("contraction too long for exact float64 digit products")
    step = max(1, chunk_bytes // (8 * M * N))
    out = torch.empty((C, M, N), dtype=torch.int64, device=x.device)
    for c0 in range(0, C, step):
        sl = slice(c0, c0 + step)
        dx = [d.to(torch.float64) for d in _digits(x[sl])]
        dy = [d.to(torch.float64) for d in _digits(y[sl])]
        terms = []
        for s in range(5):
            t = None
            for u in range(3):
                if 0 <= s - u < 3:
                    p = torch.matmul(dx[u], dy[s - u]).to(torch.int64)
                    t = p if t is None else t + p
            terms.append(t)
        out[sl] = _recombine(terms, q[sl].reshape(-1, 1, 1))
    return out


def addmod(a, b, q):
    s = a + b
    return torch.where(s >= q, s - q, s)


def submod(a, b, q):
    s = a - b
    return torch.where(s < 0, s + q, s)


# --------------------------------------------------------------------------
# the ring: moduli, the negacyclic NTT, the gadget
# --------------------------------------------------------------------------

def integer_nth_root(x: int, n: int) -> int:
    lo, hi = 0, 1 << (x.bit_length() // n + 1)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if mid ** n <= x:
            lo = mid
        else:
            hi = mid - 1
    return lo


def psi_of(q: int, l: int) -> int:
    """The NTT's root: g^((q-1)/2l) for the smallest g = 2, 3, ... whose
    power has order exactly 2l (2l a power of two: its l-th power is -1)."""
    g = 1
    while True:
        g += 1
        c = pow(g, (q - 1) // (2 * l), q)
        if pow(c, l, q) == q - 1:
            return c


class Ring:
    """R_q = Z_q[X]/(X^l + 1) over an RNS chain, on one device."""

    def __init__(self, moduli, l: int, device):
        self.moduli = [int(q) for q in moduli]
        self.L, self.l, self.device = len(self.moduli), int(l), torch.device(device)
        self.q = torch.tensor(self.moduli, dtype=torch.int64, device=self.device)
        fwd, inv = [], []
        for q in self.moduli:
            psi = psi_of(q, l)
            pinv, linv = pow(psi, -1, q), pow(l, -1, q)
            fwd.append([[pow(psi, i * (2 * j + 1) % (2 * l), q) for j in range(l)]
                        for i in range(l)])                       # [i, j]
            inv.append([[linv * pow(pinv, i * (2 * j + 1) % (2 * l), q) % q for i in range(l)]
                        for j in range(l)])                       # [j, i]
        self.fwd = torch.tensor(fwd, dtype=torch.int64, device=self.device)  # [L, l, l]
        self.inv = torch.tensor(inv, dtype=torch.int64, device=self.device)
        self.Q = math.prod(self.moduli)

    def residues(self, v):
        """Signed int64 values [..., l] -> residues [..., L, l]."""
        return torch.remainder(v[..., None, :], self.q[:, None])

    def _apply(self, x, mat):
        """x [..., L, l] times the per-limb matrix over the last axis."""
        shp = x.shape
        xc = x.reshape(-1, self.L, self.l).permute(1, 0, 2)           # [L, B, l]
        return matmul_mod(xc, mat, self.q).permute(1, 0, 2).reshape(shp)

    def ntt(self, x):
        """PowerBasis -> Ntt: y[j] = sum_i x[i] psi^(i(2j+1))."""
        return self._apply(x, self.fwd)

    def intt(self, x):
        return self._apply(x, self.inv)

    def channel_matmul(self, x, y):
        """Slot-wise products summed: x [M, K, L, l] by y [K, N, L, l] -> [M, N, L, l]."""
        M, K, L, l = x.shape
        N = y.shape[1]
        xc = x.permute(2, 3, 0, 1).reshape(L * l, M, K)
        yc = y.permute(2, 3, 0, 1).reshape(L * l, K, N)
        q = self.q.repeat_interleave(l)
        return matmul_mod(xc, yc, q).reshape(L, l, M, N).permute(2, 3, 0, 1)


def stream(name: str):
    """The encryption's draws of the program's ``noise_stream`` ``name``:
    ``streams/<name>.py`` with ``randomness(key, rows, cols, l, variance)``
    (r [R, C, l]) and ``noise(key, rows, cols, l, bound)`` (e [R, C, l])."""
    path = Path(__file__).resolve().parent / "streams" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"the reference has no noise stream {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_stream_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Scheme:
    """One parameter set: the ring, Δ and the gadget g(X) = sum Δ^i X^i."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.k, self.l, self.n = int(cfg["k"]), int(cfg["l"]), int(cfg["n"])
        self.variance = float(cfg["secret_variance"])
        self.b1, self.b2 = int(cfg["error_bound_1"]), int(cfg["error_bound_2"])
        self.ring = Ring(cfg["moduli"], self.l, device)
        self.stream = stream(cfg.get("settings", {}).get("noise_stream", "kernel"))
        self.delta = integer_nth_root(self.ring.Q, self.l)
        g = torch.tensor([[pow(self.delta, i, q) for i in range(self.l)]
                          for q in self.ring.moduli], dtype=torch.int64, device=device)
        self.gadget = self.ring.ntt(g)                                 # [L, l]
        two64 = torch.tensor([[(1 << 64) % q] for q in self.ring.moduli], device=device)
        self.wrap = mulmod(two64, self.gadget, self.ring.q[:, None])  # (2^64 mod q) g

    def ntt_small(self, v):
        return self.ring.ntt(self.ring.residues(v))

    def crs(self, k_crs):
        """A [k, k, L, l], Ntt."""
        return uniform_mod_q(k_crs, (self.k, self.k, self.l), self.ring.moduli,
                             self.ring.device)

    def public_rows(self, A, coeffs, k_gen, parties):
        """Rows ``parties`` of B: b[p] = sum_j s[p, j] A[j] + e[p], e from the
        row-keyed stream of ``k_gen`` at row p. coeffs: int [P, k, l]."""
        dev = self.ring.device
        cols = torch.arange(self.k, dtype=torch.int64, device=dev)
        s = self.ntt_small(coeffs.to(dev, torch.int64))
        e = self.ntt_small(row_uniform(k_gen, parties.to(dev), cols, self.l, self.b1))
        return addmod(self.ring.channel_matmul(s, A), e, self.ring.q[:, None])

    def encrypt_columns(self, A, B, parties, k_round, dealers, scalars,
                        encode_bits: int = 64):
        """Ciphertext columns ``dealers`` of a round: c1 [k, D, L, l] and the
        rows ``parties`` of c2 [P, D, L, l], B holding those parties' rows.
        ``scalars`` int64 [D, P] (u64 bit patterns, dealer by party);
        ``encode_bits`` 32 is the control's truncated encode."""
        dev = self.ring.device
        q = self.ring.q[:, None]
        k_r, k_e1, k_e2 = split(k_round.to(dev), 3)
        rows_k = torch.arange(self.k, dtype=torch.int64, device=dev)
        dl, pt = dealers.to(dev), parties.to(dev)
        st = self.stream
        r = self.ntt_small(st.randomness(k_r, rows_k, dl, self.l, self.variance))   # [k, D]
        c1 = addmod(self.ring.channel_matmul(A, r),
                    self.ntt_small(st.noise(k_e1, rows_k, dl, self.l, self.b1)), q)
        c2 = addmod(self.ring.channel_matmul(B, r),
                    self.ntt_small(st.noise(k_e2, pt, dl, self.l, self.b2)), q)
        return c1, addmod(c2, self.encode(scalars.to(dev).t(), encode_bits), q)

    def encode(self, sc, bits: int = 64):
        """m g for u64 scalars sc (int64 bit patterns) [...] -> [..., L, l],
        with the ``as i64`` cast: scalars >= 2^63 encode as m - 2^64."""
        q = self.ring.q[:, None]
        if bits == 32:
            sc = sc & M32
        hi, lo = ((sc >> 32) & M32)[..., None, None], (sc & M32)[..., None, None]
        m = addmod(mulmod(hi, torch.full_like(q, 1 << 32), q), lo, q)   # u64 mod q
        e = mulmod(m, self.gadget, q)
        return torch.where((sc < 0)[..., None, None], submod(e, self.wrap, q), e)

    def noisy_messages(self, sk_coeffs, c1, c2):
        """PowerBasis residues of <s, c1> - c2 (the decode negates): sk_coeffs
        [k, l], c1 [k, D, L, l], c2 [D, L, l] -> [D, L, l]."""
        s = self.ntt_small(sk_coeffs.to(self.ring.device, torch.int64))[None]   # [1, k, L, l]
        z = submod(self.ring.channel_matmul(s, c1)[0], c2, self.ring.q[:, None])
        return self.ring.intt(z)


def center(x: int, q: int) -> int:
    r = x % q
    return r - q if r > q // 2 else r


def _tdiv(a: int, b: int) -> int:
    """Division truncated toward zero (Rust's /)."""
    qt = abs(a) // abs(b)
    return qt if (a >= 0) == (b >= 0) else -qt


def _trem(a: int, b: int) -> int:
    return a - b * _tdiv(a, b)


def extract_u64(mf: int, q: int) -> int:
    """The constant term as the reference returns it: small negatives clamp
    to 0; other negatives map through (mf + q) mod q; >= 2^64 gives 0."""
    if mf < 0:
        if -mf <= 1000:
            return 0
        pos = (mf + q) % q
        return pos if pos < 1 << 64 else 0
    return mf if mf < 1 << 64 else 0


def decode(scheme: Scheme, z: list[int]) -> int:
    """The exact sequential-rounding decode of one message, z the l lifted
    coefficients in [0, q) (the reference's decryption.rs:10-58)."""
    q, delta, ell = scheme.ring.Q, scheme.delta, scheme.l
    zc = [center(v, q) for v in z]
    tmp = [(zc[i] * delta - zc[i + 1]) % q for i in range(ell - 1)]
    last = tmp[0]
    for i in range(1, ell - 1):
        last = (last * delta + tmp[i]) % q
    a = center(last, q)
    m = center(delta ** (ell - 1) % q, q)
    red = _trem(a, m)
    half = _tdiv(m, 2)
    if red > half:
        red -= m
    elif red < -half:
        red += m
    tmp.append(red % q)
    noise = [0] * ell
    noise[ell - 1] = tmp[ell - 1]
    dc = center(delta % q, q)
    for i in range(ell - 2, -1, -1):
        a = center((noise[i + 1] - tmp[i]) % q, q)
        if dc == 0:
            quot = 0
        elif a < 0:
            quot = _tdiv(a * 2 - dc, dc * 2)
        else:
            quot = _tdiv(a * 2 + dc, dc * 2)
        noise[i] = quot % q
    return extract_u64(center((-zc[0] - noise[0]) % q, q), q)


def decode_one_coefficient(scheme: Scheme, z: list[int]) -> int:
    """The control's decode: m from the top gadget coefficient alone,
    round(z[l-1] / Δ^(l-1)), skipping the sequential rounding."""
    q = scheme.ring.Q
    top = scheme.delta ** (scheme.l - 1)
    a = center(z[-1], q)
    m = (2 * a + top) // (2 * top)
    return extract_u64(m, q)


def lift(scheme: Scheme, res) -> list[list[int]]:
    """CRT lift of residues [D, L, l] (host) -> D lists of l ints in [0, Q)."""
    ring = scheme.ring
    Q = ring.Q
    basis = [(Q // q) * pow(Q // q, -1, q) for q in ring.moduli]
    rows = res.cpu().tolist()
    return [[sum(b * limbs[i][j] for i, b in enumerate(basis)) % Q for j in range(ring.l)]
            for limbs in rows]


def expected_share(m: int, q: int) -> int:
    """What an exact decryption returns for u64 scalar m, encoded with the
    ``as i64`` cast and decoded without residual noise."""
    signed = m - (1 << 64) if m >= 1 << 63 else m
    return extract_u64(center(signed % q, q), q)
