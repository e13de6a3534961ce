"""Decryption's contraction kernel (``csrc/noisy_messages.cu``) around its
launch, on the CPU: what ``fused_modmat.noisy_messages`` does with CPU
tensors, the table the wrapper hands the kernel (applied here by a
Python-integer model of the kernel's arithmetic), its refusals and its
counter. The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
No JAX.
"""

import numpy as np
import pytest
import torch

from pvw_tpu_torch.crypto import decryption as dec
from pvw_tpu_torch.ops import fused_modmat as fm
from pvw_tpu_torch.ops import modmat, ntt, u64
from pvw_tpu_torch.params.parameters import PvwParameters, PvwParametersBuilder
from pvw_tpu_torch.params.ring import get_ring
from pvw_tpu_torch.utils.intmath import generate_ntt_primes

M64 = (1 << 64) - 1
CHAINS = {
    "toy": ((0xFFFFC4001, 0x1FFFFE0001), 8),
    "config4": (tuple(generate_ntt_primes(61, 17, 16)), 16),
    "reference": (tuple(generate_ntt_primes(55, 4, 8)), 8),
    "one_limb": ((0xFFFFC4001,), 8),
}


def params(moduli, l):
    b1, b2 = PvwParameters.suggest_error_bounds(4, 16, l, moduli, 0.5)
    return (PvwParametersBuilder().set_parties(4).set_dimension(16).set_l(l)
            .set_moduli(moduli).set_secret_variance(0.5).set_error_bounds_u32(b1, b2)
            .build())


def ring_of(chain):
    """The ring of ``chain``; "restricted" is the config-4 set's limb view
    (1, 5, 16), as the limb-parallel backend hands it."""
    if chain == "restricted":
        return params(*CHAINS["config4"]).restrict_limbs((1, 5, 16)).ring
    return get_ring(*CHAINS[chain])


def operands(ring, k, d, seed):
    """Canonical residues: sk [k, L, l], c1 [L, l, k, d], c2 [L, l, d], the
    largest residue q - 1 in the first row and column."""
    rng = np.random.default_rng(seed)
    L, l = ring.num_limbs, ring.degree
    q = ring.q.astype(object)

    def residues(shape, axis):
        return np.stack([rng.integers(0, int(m), size=shape, dtype=np.uint64)
                         for m in ring.moduli], axis)

    sk = residues((k, l), 1)                                  # [k, L, l]
    c1 = residues((l, k, d), 0)                               # [L, l, k, d]
    c2 = residues((l, d), 0)                                  # [L, l, d]
    sk[0] = (q - 1)[:, None]
    c1[:, :, :, 0] = (q - 1)[:, None, None]
    return u64.u64_tensor(sk), u64.u64_tensor(c1), u64.u64_tensor(c2)


def block(ring):
    """The table the wrapper hands the kernel, as uint64 on the host."""
    return u64.u64_numpy(fm.contraction_tables(ring, "cpu"))


def shoup(x, w, wp, q):
    """The kernel's ``shoup`` (modarith.cuh) on Python ints: the product
    and difference wrap mod 2^64, and the value before the correction lies
    in [0, 2q)."""
    r = (w * x - ((wp * x) >> 64) * q) & M64
    assert r < 2 * q
    return r - q if r >= q else r


def reduce3(v, c):
    """The kernel's ``reduce3`` of the exact sum v, split in three words."""
    q = c[0]
    lo, hi, top = v & M64, (v >> 64) & M64, v >> 128
    assert top <= M64
    r = shoup(lo, 1, c[1], q)
    r = (r + shoup(hi, c[2], c[3], q)) % q
    return (r + shoup(top, c[4], c[5], q)) % q


def model(tab, sk, c1, c2=None, splits=1):
    """The kernel's arithmetic on Python ints from its table ``tab``
    [L, 8 + 2 l^2]: each k range's exact sum reduced by ``reduce3``, the
    ranges added mod q; then minus c2 and the inverse NTT by the table's
    Shoup pairs. -> [d, L, l], or [L, l, d] without c2, as uint64."""
    sk, c1 = u64.u64_numpy(sk).astype(object), u64.u64_numpy(c1).astype(object)
    L, l, k, d = c1.shape
    kc = -(-k // splits)
    acc = np.zeros((L, l, d), object)
    for i in range(L):
        c = [int(w) for w in tab[i, :6]]
        q = c[0]
        for j in range(l):
            for s in range(splits):
                t0, t1 = s * kc, min(k, (s + 1) * kc)
                sums = (sk[t0:t1, i, j][:, None] * c1[i, j, t0:t1]).sum(0) if t1 > t0 \
                    else np.zeros(d, object)
                acc[i, j] = [(a + reduce3(int(v), c)) % q for a, v in zip(acc[i, j], sums)]
    if c2 is None:
        return acc.astype(np.uint64)
    return ntt_model(tab, (acc - u64.u64_numpy(c2).astype(object)).transpose(2, 0, 1)
                     % np.array([int(w) for w in tab[:, 0]], object)[:, None])


def ntt_model(tab, z):
    """The kernel's inverse NTT of z [d, L, l] (canonical) from the table."""
    d, L, l = z.shape
    inv = tab[:, 8:].reshape(L, l, l, 2)
    out = np.zeros((d, L, l), np.uint64)
    for i in range(L):
        q = int(tab[i, 0])
        for c in range(d):
            for s in range(l):
                x = 0
                for j in range(l):
                    x = (x + shoup(int(z[c, i, j]), int(inv[i, j, s, 0]),
                                   int(inv[i, j, s, 1]), q)) % q
                out[c, i, s] = x
    return out


def todays(ring, sk, c1, c2):
    """The plain composition as the decryption computed it before the
    kernel: ``matmul_channels`` over k, minus c2, ``ntt_inverse``."""
    prod = modmat.matmul_channels(sk.permute(1, 2, 0)[:, :, None, :], c1, ring)[:, :, 0]
    q = ring.table("q", prod.device)[:, None, None]
    return prod, ntt.ntt_inverse(u64.submod(prod, c2, q).permute(2, 0, 1), ring)


@pytest.mark.parametrize("chain", list(CHAINS) + ["restricted"])
def test_cpu_tensor_takes_the_plain_twin(chain):
    """CPU tensors take the twin, whose answers are today's composition,
    whole and partial, with c2 as a strided view; nothing is launched."""
    ring = ring_of(chain)
    sk, c1, c2 = operands(ring, 12, 7, len(chain))
    prod, want = todays(ring, sk, c1, c2)
    launched = fm.noisy_messages.launches
    got = fm.noisy_messages(ring, sk, c1, c2)
    part = fm.noisy_messages(ring, sk, c1)
    c2_view = torch.stack([c2, c2], -1)[..., 1]
    assert not c2_view.is_contiguous()
    assert torch.equal(fm.noisy_messages(ring, sk, c1, c2_view), want)
    assert fm.noisy_messages.launches == launched
    assert got.dtype == torch.int64 and got.shape == (7, ring.num_limbs, ring.degree)
    assert torch.equal(got, want) and torch.equal(part, prod)
    assert torch.equal(got, fm.noisy_messages_plain(ring, sk, c1, c2))
    assert torch.equal(dec._contraction(ring, sk, c1), prod)
    assert torch.equal(dec._noisy_finish(ring, prod, c2), want)


@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("chain", list(CHAINS) + ["restricted"])
def test_kernel_model_reproduces_the_twin(chain, splits):
    """The kernel's arithmetic, applied with the wrapper's table by a
    Python-integer model over 1, 2 or 4 k ranges, gives the twin's
    residues, whole and partial."""
    ring = ring_of(chain)
    sk, c1, c2 = operands(ring, 9, 5, 3)
    tab = block(ring)
    want = fm.noisy_messages_plain(ring, sk, c1, c2)
    assert np.array_equal(model(tab, sk, c1, c2, splits), u64.u64_numpy(want))
    assert np.array_equal(model(tab, sk, c1, None, splits),
                          u64.u64_numpy(fm.noisy_messages_plain(ring, sk, c1)))


@pytest.mark.parametrize("chain", list(CHAINS) + ["restricted"])
def test_table_inverse_ntt_is_ntt_inverse(chain):
    """The table's transposed matrix and Shoup pairs, applied as the
    kernel applies them, reproduce ``ntt.ntt_inverse`` on random and edge
    residues (0 and q - 1)."""
    ring = ring_of(chain)
    rng = np.random.default_rng(11)
    z = np.stack([rng.integers(0, int(m), size=(6, ring.degree), dtype=np.uint64)
                  for m in ring.moduli], 1)
    z[0] = 0
    z[1] = (ring.q - np.uint64(1))[:, None]
    want = ntt.ntt_inverse(u64.u64_tensor(z), ring)
    assert np.array_equal(ntt_model(block(ring), z), u64.u64_numpy(want))


@pytest.mark.parametrize("chain", list(CHAINS) + ["restricted"])
def test_table_reduces_three_words(chain):
    """``reduce3`` with the table's constants is v mod q for the extremes a
    sum of k <= 4096 products can take, and for random three-word values."""
    ring = ring_of(chain)
    tab = block(ring)
    rng = np.random.default_rng(5)
    for i, q in enumerate(ring.moduli):
        c = [int(w) for w in tab[i, :6]]
        assert c[0] == q and c[1] == (1 << 64) // q
        assert (c[2], c[4]) == ((1 << 64) % q, (1 << 128) % q)
        assert not tab[i, 6:8].any()
        vals = [0, 1, q - 1, q, M64, 1 << 64, (1 << 128) - 1, 1 << 128,
                4096 * (q - 1) ** 2] + [int(a) << 128 | int(b) << 64 | int(e) for a, b, e in
                                        rng.integers(0, 1 << 12, (20, 3), dtype=np.uint64)]
        vals += [int(rng.integers(0, 1 << 62)) * int(rng.integers(0, 1 << 62)) * 1000
                 for _ in range(20)]
        for v in vals:
            assert reduce3(v, c) == v % q


def test_tables_are_cached_per_ring_and_device():
    ring = ring_of("config4")
    tab = fm.contraction_tables(ring, "cpu")
    assert tab.dtype == torch.int64 and tab.shape == (17, 8 + 2 * 16 * 16)
    assert fm.contraction_tables(ring, torch.device("cpu")) is tab
    sub = ring_of("restricted")
    assert sub.num_limbs == 3
    np.testing.assert_array_equal(block(sub), block(ring)[[1, 5, 16]])


def _bad_cases(ring):
    sk, c1, c2 = operands(ring, 6, 4, 1)
    meta = torch.device("meta")
    other = get_ring(*CHAINS["one_limb"])
    return {
        "sk int32": (ring, sk.to(torch.int32), c1, c2),
        "c1 int32": (ring, sk, c1.to(torch.int32), c2),
        "c2 uint8": (ring, sk, c1, c2.to(torch.uint8)),
        "sk k": (ring, sk[:5], c1, c2),
        "c1 axes": (ring, sk, c1[..., 0], c2),
        "c2 d": (ring, sk, c1, c2[..., :3]),
        "another ring": (other, sk, c1, c2),
        "sk elsewhere": (ring, sk.to(meta), c1, c2),
        "c2 elsewhere": (ring, sk, c1, c2.to(meta)),
        "meta": (ring, sk.to(meta), c1.to(meta), c2.to(meta)),
    }


@pytest.mark.parametrize("case", list(_bad_cases(get_ring(*CHAINS["toy"]))))
def test_wrapper_raises_on_bad_inputs(case):
    """Wrong dtypes, shapes or ring, operands on different devices, and a
    device that is neither the CPU nor a card: each raises, nothing is
    launched."""
    args = _bad_cases(get_ring(*CHAINS["toy"]))[case]
    launched = fm.noisy_messages.launches
    with pytest.raises(ValueError):
        fm.noisy_messages(*args)
    assert fm.noisy_messages.launches == launched


def test_launch_counters_list_the_contraction_kernel():
    counters = fm.launch_counters()
    assert counters[fm.CONTRACTION_KERNEL] == (fm.noisy_messages, "launches")
    assert fm.CONTRACTION_KERNEL == "noisy_messages"
    assert fm.CONTRACTION_ENTRY[:2] == ("noisy_messages", "pvw_noisy_messages")
    assert len(fm.CONTRACTION_ENTRY[2]) == 19
