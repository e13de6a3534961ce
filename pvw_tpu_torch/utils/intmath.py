"""Host-side exact integer mathematics.

Replaces the reference's ``num-bigint`` substrate (``parameters.rs:151-163``
delta/nth-root, ``decryption.rs:140-152`` centered reduction, the RNS/CRT
constants that fhe-math's ``RnsContext`` provides) with plain Python ints.
Everything here runs on the host once per parameter set; nothing is in the
device hot path.
"""

from __future__ import annotations

from functools import lru_cache


def integer_nth_root(x: int, n: int) -> int:
    """Exact floor(x ** (1/n)) for non-negative ``x`` (BigUint::nth_root).

    Newton's method on integers; used for Δ = ⌊q^(1/ℓ)⌋
    (``parameters.rs:156``).
    """
    if x < 0:
        raise ValueError("nth root of negative number")
    if n <= 0:
        raise ValueError("root degree must be positive")
    if x in (0, 1) or n == 1:
        return x
    # Initial guess from bit length: 2^ceil(bits/n) >= x^(1/n).
    guess = 1 << ((x.bit_length() + n - 1) // n)
    while True:
        nxt = ((n - 1) * guess + x // guess ** (n - 1)) // n
        if nxt >= guess:
            break
        guess = nxt
    # Newton can overshoot by one in edge cases; correct downward/upward.
    while guess ** n > x:
        guess -= 1
    while (guess + 1) ** n <= x:
        guess += 1
    return guess


def is_probable_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all u64)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@lru_cache(maxsize=None)
def _factorize(n: int) -> tuple[int, ...]:
    """Prime factorization by trial division + Pollard rho (small inputs)."""
    factors: list[int] = []
    for p in (2, 3, 5, 7, 11, 13):
        while n % p == 0:
            factors.append(p)
            n //= p
    if n == 1:
        return tuple(sorted(set(factors)))

    def rho(m: int) -> int:
        if is_probable_prime(m):
            return m
        for c in range(1, 100):
            x, y, d = 2, 2, 1
            while d == 1:
                x = (x * x + c) % m
                y = (y * y + c) % m
                y = (y * y + c) % m
                d = _gcd(abs(x - y), m)
            if d != m:
                return d
        raise ArithmeticError(f"failed to factor {m}")

    stack = [n]
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        if is_probable_prime(m):
            factors.append(m)
        else:
            d = rho(m)
            stack.extend((d, m // d))
    return tuple(sorted(set(factors)))


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def primitive_root_of_unity(order: int, q: int) -> int:
    """Smallest-candidate primitive ``order``-th root of unity mod prime q.

    Deterministic search (candidates 2, 3, ...) so plans are reproducible.
    Requires ``order | q - 1``.
    """
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide q-1 for q={q}")
    cofactor = (q - 1) // order
    prime_factors = _factorize(order)
    g = 1
    while True:
        g += 1
        cand = pow(g, cofactor, q)
        if cand == 1:
            continue
        if all(pow(cand, order // p, q) != 1 for p in prime_factors):
            return cand


def center_mod(x: int, q: int) -> int:
    """Centered representative matching ``decryption.rs:140-152``: reduce to
    [0, q) then subtract q iff the value is STRICTLY greater than q // 2.

    Note the reference's boundary convention: q//2 itself stays positive.
    """
    r = x % q
    return r - q if r > q // 2 else r


def rust_div(a: int, b: int) -> int:
    """Rust ``BigInt`` division semantics: truncation toward zero.

    Python's ``//`` floors; the decode rounding convention
    (``decryption.rs:188-196``, tested at ``tests/crypto.rs:308-330``)
    depends on truncated division.
    """
    if b == 0:
        raise ZeroDivisionError
    qd, rm = divmod(abs(a), abs(b))
    if (a < 0) != (b < 0) and qd != 0:
        return -qd
    if (a < 0) != (b < 0):
        return 0
    return qd


def rust_rem(a: int, b: int) -> int:
    """Rust ``%`` semantics: remainder has the sign of the dividend."""
    r = abs(a) % abs(b)
    return -r if a < 0 else r


class CrtBasis:
    """CRT lift/reduce constants for an RNS basis (fhe-math ``RnsContext``).

    For moduli q_0..q_{L-1} with q = ∏ q_i:
      lift(residues) = Σ_i ((r_i * qhat_inv_i) mod q_i) * qhat_i  (mod q)
    """

    def __init__(self, moduli: tuple[int, ...]) -> None:
        self.moduli = tuple(int(m) for m in moduli)
        q = 1
        for m in self.moduli:
            q *= m
        self.q = q
        self.qhat = tuple(q // m for m in self.moduli)
        self.qhat_inv = tuple(
            pow(h % m, -1, m) for h, m in zip(self.qhat, self.moduli)
        )

    def lift(self, residues: tuple[int, ...] | list[int]) -> int:
        """Residues -> canonical representative in [0, q)."""
        acc = 0
        for r, m, h, hi in zip(residues, self.moduli, self.qhat, self.qhat_inv):
            acc += (int(r) * hi % m) * h
        return acc % self.q

    def lift_centered(self, residues) -> int:
        """Residues -> centered representative (``center_mod`` convention)."""
        return center_mod(self.lift(residues), self.q)

    def reduce(self, x: int) -> tuple[int, ...]:
        """Integer -> residue tuple (negative values wrap per modulus, the
        ``bigints_to_poly`` convention of ``parameters.rs:437-451``)."""
        return tuple(x % m for m in self.moduli)


def generate_ntt_primes(bit_size: int, count: int, degree: int) -> tuple[int, ...]:
    """Generate ``count`` distinct NTT-friendly primes of exactly
    ``bit_size`` bits (q ≡ 1 mod 2*degree, q < 2^62), searching downward
    from 2^bit_size — deterministic, so parameter sets are reproducible.

    The analogue of fhe.rs's prime-generation helper that the reference's
    users rely on for building RNS chains (the reference itself takes
    moduli as raw u64 inputs, e.g. ``tests/params.rs:21``).
    """
    if bit_size < 14 or bit_size > 61:
        raise ValueError("bit_size must be in [14, 61]")
    step = 2 * degree
    out: list[int] = []
    # largest candidate ≡ 1 mod 2l strictly below 2^bit_size
    cand = ((1 << bit_size) - 2) // step * step + 1
    while len(out) < count and cand > (1 << (bit_size - 1)):
        if is_probable_prime(cand):
            out.append(cand)
        cand -= step
    if len(out) < count:
        raise ValueError(
            f"not enough {bit_size}-bit NTT primes for degree {degree}"
        )
    return tuple(out)


def validate_ntt_modulus(q: int, degree: int) -> None:
    """Check q is an NTT-friendly prime for negacyclic degree ``degree``:
    prime, odd, q ≡ 1 (mod 2·degree), and q < 2^62 (both fhe-math's Context
    requirement and our digit-decomposition headroom bound).
    """
    from ..errors import InvalidParameters

    if q >= (1 << 62):
        raise InvalidParameters(f"modulus {q:#x} must be < 2^62")
    if q % (2 * degree) != 1:
        raise InvalidParameters(
            f"modulus {q:#x} is not ≡ 1 mod 2*l={2 * degree} (not NTT-friendly)"
        )
    if not is_probable_prime(q):
        raise InvalidParameters(f"modulus {q:#x} is not prime")
