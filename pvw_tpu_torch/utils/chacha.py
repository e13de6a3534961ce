"""ChaCha8 keystream RNG (host, numpy) for deterministic CRS generation.

Re-implements the semantics the reference gets from ``rand_chacha``'s
``ChaCha8Rng`` (``crs.rs:45-67``): a 32-byte seed keys a ChaCha8 stream;
``gen::<[u8; 32]>()`` pulls 32 sequential bytes; ``next_u32``/``next_u64``
pull little-endian words. State layout follows rand_chacha 0.3: the four
"expand 32-byte k" constants, the 8-word key, a 64-bit block counter in
words 12-13 and a 64-bit stream id (0) in words 14-15; blocks are emitted
as the 16 post-addition words serialized little-endian.

Used for: master-seed -> per-element 32-byte seeds (``crs.rs:58-60``) and
per-element uniform residue streams (our documented analogue of fhe-math's
``Poly::random_from_seed``). Compatibility with the exact rand_chacha /
fhe-math byte streams cannot be verified in this build environment (no Rust
toolchain); the algorithm and layout match the published rand_chacha 0.3
design and are pinned by golden vectors in tests/test_params.py so the
stream can never drift silently between versions of THIS library.
"""

from __future__ import annotations

import numpy as np

_CONSTANTS = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter_round(s, a, b, c, d):
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] += s[b]
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] += s[d]
    s[b] = _rotl(s[b] ^ s[c], 7)


def chacha_blocks(seed: bytes, first_block: int, n_blocks: int, rounds: int = 8) -> bytes:
    """Generate ``n_blocks`` 64-byte ChaCha blocks starting at block counter
    ``first_block``. Vectorized over blocks with numpy."""
    if len(seed) != 32:
        raise ValueError("seed must be 32 bytes")
    key = np.frombuffer(seed, dtype="<u4")
    counters = np.arange(first_block, first_block + n_blocks, dtype=np.uint64)
    state = np.zeros((16, n_blocks), dtype=np.uint32)
    state[0:4] = _CONSTANTS[:, None]
    state[4:12] = key[:, None]
    state[12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    state[13] = (counters >> np.uint64(32)).astype(np.uint32)
    # words 14-15: stream id, zero by default
    work = state.copy()
    old = np.seterr(over="ignore")
    try:
        for _ in range(rounds // 2):
            _quarter_round(work, 0, 4, 8, 12)
            _quarter_round(work, 1, 5, 9, 13)
            _quarter_round(work, 2, 6, 10, 14)
            _quarter_round(work, 3, 7, 11, 15)
            _quarter_round(work, 0, 5, 10, 15)
            _quarter_round(work, 1, 6, 11, 12)
            _quarter_round(work, 2, 7, 8, 13)
            _quarter_round(work, 3, 4, 9, 14)
        work += state
    finally:
        np.seterr(**old)
    # serialize: per block, 16 words little-endian
    return work.T.astype("<u4").tobytes()


def chacha_blocks_multi(
    seeds: np.ndarray, n_blocks: int, rounds: int = 8
) -> np.ndarray:
    """ChaCha blocks for MANY seeds at once (vectorized keygen for CRS
    matrices). ``seeds``: uint8 [N, 32]; returns uint8 [N, n_blocks * 64]
    with each row being that seed's keystream from block counter 0."""
    seeds = np.asarray(seeds, np.uint8)
    n = seeds.shape[0]
    keys = seeds.view("<u4").reshape(n, 8)                       # [N, 8]
    counters = np.arange(n_blocks, dtype=np.uint64)
    state = np.zeros((16, n, n_blocks), dtype=np.uint32)
    state[0:4] = _CONSTANTS[:, None, None]
    state[4:12] = keys.T[:, :, None]
    state[12] = (counters & np.uint64(0xFFFFFFFF)).astype(np.uint32)[None, :]
    state[13] = (counters >> np.uint64(32)).astype(np.uint32)[None, :]
    work = state.copy()
    old = np.seterr(over="ignore")
    try:
        for _ in range(rounds // 2):
            _quarter_round(work, 0, 4, 8, 12)
            _quarter_round(work, 1, 5, 9, 13)
            _quarter_round(work, 2, 6, 10, 14)
            _quarter_round(work, 3, 7, 11, 15)
            _quarter_round(work, 0, 5, 10, 15)
            _quarter_round(work, 1, 6, 11, 12)
            _quarter_round(work, 2, 7, 8, 13)
            _quarter_round(work, 3, 4, 9, 14)
        work += state
    finally:
        np.seterr(**old)
    # [16, N, B] -> per (N, B) block of 16 LE words -> [N, B*64] bytes
    out = np.transpose(work, (1, 2, 0)).astype("<u4")
    return out.reshape(n, -1).view(np.uint8)


def _lemire_region_size(q: int, degree: int) -> int:
    """Deterministic per-(element, limb) u64 budget for rejection sampling.

    Part of the documented stream layout: larger primes reject more often
    (p = ((2^64 - q) % q) / 2^64, up to ~1/4), so the reserved region grows
    with an upper estimate of p. Changing this function changes the
    deterministic CRS values — it is pinned by golden vectors in tests.
    """
    ints_to_reject = ((1 << 64) - q) % q
    frac = ints_to_reject >> 56  # p in units of 1/256, rounded down
    return degree + 16 + (degree * int(frac) * 4) // 256


def uniform_residues_from_seeds(
    seeds: np.ndarray, moduli: tuple[int, ...], degree: int
) -> np.ndarray:
    """Deterministic uniform residue sampling: per-element 32-byte seeds ->
    uint64 residues [N, L, degree], each uniform in [0, q_limb).

    Documented stream layout (this library's convention for the reference's
    ``Poly::random_from_seed``, whose fhe-math internals are not observable
    here): element e's ChaCha8 keystream is split into one contiguous region
    of ``_lemire_region_size(q_i, degree)`` u64s per limb i (limb-major),
    plus a shared 64-u64 extension region at the end. Within a region, u64s
    are consumed sequentially with Lemire widening-multiply rejection
    (unbiased); draws that exhaust their region continue — in (limb, slot)
    order — from the extension region.
    """
    seeds = np.asarray(seeds, np.uint8)
    n = seeds.shape[0]
    regions = [_lemire_region_size(q, degree) for q in moduli]
    offsets = np.cumsum([0] + regions)
    ext = 64
    total_u64 = int(offsets[-1]) + ext
    n_blocks = -(-total_u64 * 8 // 64)
    stream = chacha_blocks_multi(seeds, n_blocks)                # [N, B*64]
    pool = stream[:, : total_u64 * 8].view("<u8")                # [N, total]

    out = np.zeros((n, len(moduli), degree), np.uint64)
    leftovers: list[tuple[int, int, int]] = []  # (elem, limb, still_needed)
    for li, q in enumerate(moduli):
        r = regions[li]
        zone = (1 << 64) - 1 - (((1 << 64) - q) % q)
        block = pool[:, offsets[li] : offsets[li] + r]            # [N, r]
        m_lo = block * np.uint64(q)  # low 64 bits (wraps) — need exact check
        # Lemire acceptance: low-64 of v*q <= zone. Compute exactly with
        # object dtype only where the fast path is ambiguous? q < 2^62 so
        # low64(v*q) = (v*q) mod 2^64; numpy uint64 multiply wraps => exact.
        accept = m_lo <= np.uint64(zone)
        hi = _mulhi_u64(block, q)                                 # value = hi
        cum = np.cumsum(accept, axis=1)
        take = accept & (cum <= degree)
        # scatter accepted values into position cum-1
        rows, cols = np.nonzero(take)
        out[rows, li, cum[rows, cols] - 1] = hi[rows, cols]
        got = cum[:, -1].clip(max=degree)
        for e in np.nonzero(got < degree)[0]:
            leftovers.append((int(e), li, degree - int(got[e])))

    if leftovers:
        # Extremely rare: continue from the extension region, sequentially
        # per element in (limb, slot) order.
        ext_pos = {e: 0 for e, _, _ in leftovers}
        for e, li, needed in sorted(leftovers, key=lambda t: (t[0], t[1])):
            q = moduli[li]
            zone = (1 << 64) - 1 - (((1 << 64) - q) % q)
            filled = degree - needed
            while needed:
                if ext_pos[e] >= ext:
                    raise RuntimeError("extension region exhausted")
                v = int(pool[e, int(offsets[-1]) + ext_pos[e]])
                ext_pos[e] += 1
                m = v * q
                if (m & ((1 << 64) - 1)) <= zone:
                    out[e, li, filled] = m >> 64
                    filled += 1
                    needed -= 1
    return out


def _mulhi_u64(v: np.ndarray, q: int) -> np.ndarray:
    """High 64 bits of uint64-array * python-int (q < 2^64), exact."""
    v = v.astype(np.uint64)
    v_lo = v & np.uint64(0xFFFFFFFF)
    v_hi = v >> np.uint64(32)
    q_lo = np.uint64(q & 0xFFFFFFFF)
    q_hi = np.uint64(q >> 32)
    ll = v_lo * q_lo
    lh = v_lo * q_hi
    hl = v_hi * q_lo
    hh = v_hi * q_hi
    mid = (ll >> np.uint64(32)) + (lh & np.uint64(0xFFFFFFFF)) + (
        hl & np.uint64(0xFFFFFFFF)
    )
    return hh + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) + (
        mid >> np.uint64(32)
    )


class ChaCha8Rng:
    """Sequential byte/word stream over the ChaCha8 keystream."""

    def __init__(self, seed: bytes) -> None:
        self.seed = bytes(seed)
        self._buf = b""
        self._next_block = 0

    def _refill(self, need: int) -> None:
        blocks = max(4, -(-need // 64))
        self._buf += chacha_blocks(self.seed, self._next_block, blocks)
        self._next_block += blocks

    def next_bytes(self, n: int) -> bytes:
        if len(self._buf) < n:
            self._refill(n - len(self._buf))
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def next_u32(self) -> int:
        return int.from_bytes(self.next_bytes(4), "little")

    def next_u64(self) -> int:
        return int.from_bytes(self.next_bytes(8), "little")

    def gen_seed32(self) -> bytes:
        """``rng.gen::<[u8; 32]>()`` — 32 sequential stream bytes."""
        return self.next_bytes(32)

    def uniform_u64_below(self, bound: int) -> int:
        """Uniform u64 in [0, bound) via rand 0.8's widening-multiply
        rejection (Lemire): unbiased, matches ``UniformInt<u64>``."""
        if not 0 < bound <= 1 << 64:
            raise ValueError("bound out of range")
        if bound == 1 << 64:
            return self.next_u64()
        range_ = bound
        ints_to_reject = ((1 << 64) - range_) % range_
        zone = (1 << 64) - 1 - ints_to_reject
        while True:
            v = self.next_u64()
            m = v * range_
            hi, lo = m >> 64, m & ((1 << 64) - 1)
            if lo <= zone:
                return hi
