"""The device decode's kernel (``csrc/pvw_decode.cu``) around its launch,
on the CPU: what ``decode_residues`` does with a CPU tensor, the packed
table block the wrapper hands the kernel, its caps and its counter. The
kernel itself runs only on a card (``tests/test_torch_cuda.py``). No JAX.
"""

import numpy as np
import pytest
import torch

from pvw_tpu_torch.crypto import device_decode as dd
from pvw_tpu_torch.ops import fused_modmat as fm
from pvw_tpu_torch.ops import mw, u64
from pvw_tpu_torch.params import presets
from pvw_tpu_torch.params.parameters import PvwParameters, PvwParametersBuilder
from pvw_tpu_torch.utils.intmath import generate_ntt_primes

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


def residues(p, d, seed):
    """d residue blocks [d, L, l]: rows lifting to q//2, q//2 + 1 and 0, the
    encodings -(v Δ^j) of v = ±1000, ±1001 and 2^64, then uniform rows."""
    q, delta, l = p.q_total(), p.delta(), p.l
    rng = np.random.default_rng(seed)
    rows = [[q // 2] * l, [q // 2 + 1] * l, [0] * l] + \
        [[(-(v % q) * delta ** j) % q for j in range(l)] for v in (-1000, 1000, -1001, 1001,
                                                                   1 << 64)]
    res = np.stack([rng.integers(0, m, size=(d, l), dtype=np.uint64) for m in p.ring.moduli], 1)
    for r, coeffs in enumerate(rows[:d]):
        res[r] = p.ring.residues_from_int_coeffs(coeffs)
    return res


@pytest.mark.parametrize("chain", list(CHAINS))
def test_cpu_tensor_takes_the_plain_twin(chain):
    """On a CPU tensor the wrapper's answer is the twin's, the call is
    counted and no kernel is launched."""
    p = params(*CHAINS[chain])
    plan = dd.get_plan(p)
    z = u64.u64_tensor(residues(p, 37, len(chain)))
    calls, launches = dd.decode_residues.calls, dd.decode_residues.launches
    got = dd.decode_residues(plan, z)
    assert dd.decode_residues.calls == calls + 1
    assert dd.decode_residues.launches == launches
    assert got.device.type == "cpu" and got.dtype == torch.int64 and got.shape == (37,)
    assert torch.equal(got, dd.decode_residues_plain(plan, z))
    assert dd.decode_residues.calls == calls + 1


@pytest.mark.parametrize("chain", list(CHAINS) + ["broadcast_128bit"])
def test_kernel_block_decodes_back_to_the_plan(chain):
    """The packed block's sections are the plan's own tables and its
    divisors' words, and its sizes are the plan's."""
    p = presets.broadcast_128bit(4) if chain == "broadcast_128bit" else params(*CHAINS[chain])
    plan = dd.get_plan(p)
    dims = plan.kernel_dims()
    L, ell, W, nwq, m_fw, m_nr, m_nd, m_nq, v_fw, v_nr, v_nd, v_nq = dims
    assert (L, ell, W, nwq) == (plan.L, plan.ell, plan.W, plan.NWq)
    for (fw, nr, nd, nq), dv in (((m_fw, m_nr, m_nd, m_nq), plan.mod_dpow),
                                 ((v_fw, v_nr, v_nd, v_nq), plan.div2d)):
        assert (fw, nq) == (dv.fw, dv.nw_q) and fw <= W and nq <= fw and nr <= fw
        assert mw.int_from_words(dv.r_words) == (1 << (32 * fw)) // dv.d
        assert mw.int_from_words(dv.d_words) == dv.d and (nr, nd) == (len(dv.r_words),
                                                                      len(dv.d_words))
    block = plan.kernel_block()
    sec = dd.split_kernel_block(dims, block)
    host = plan._host
    for name in ("q", "qinv", "qinv_sh", "d", "d_sh", "p32", "p32_sh", "qhat", "q_words",
                 "half_q", "q_multiples", "half_m", "delta_div"):
        np.testing.assert_array_equal(sec[name], host[name], err_msg=name)
    np.testing.assert_array_equal(sec["mod_r"], plan.mod_dpow.r_words)
    np.testing.assert_array_equal(sec["mod_d"], plan.mod_dpow.d_words)
    np.testing.assert_array_equal(sec["div_r"], plan.div2d.r_words)
    np.testing.assert_array_equal(sec["div_d"], plan.div2d.d_words)
    q, delta = p.q_total(), p.delta()
    assert mw.int_from_words(sec["q_words"]) == q
    assert [mw.int_from_words(r) for r in sec["q_multiples"]] == [j * q for j in range(L)]
    assert mw.int_from_words(sec["mod_d"]) == delta ** (ell - 1)
    assert mw.int_from_words(sec["div_d"]) == 2 * delta
    assert mw.int_from_words(sec["delta_div"]) == delta
    tab = plan.kernel_tables("cpu")
    assert tab.dtype == torch.int64 and torch.equal(tab, torch.from_numpy(block))
    assert plan.kernel_tables("cpu") is tab
    with pytest.raises(ValueError):
        dd.split_kernel_block(dims, np.append(block, 0))


@pytest.mark.parametrize("name", sorted(presets.PRESETS))
def test_every_preset_is_within_the_kernel_caps(name):
    plan = dd.get_plan(presets.get_preset(name))
    assert plan.supported and plan.kernel_fits()
    assert plan.L <= dd.MAX_LIMBS and 2 <= plan.ell <= dd.MAX_ELL and plan.W <= dd.MAX_WORDS


@pytest.mark.parametrize("moduli,ell", [(tuple(generate_ntt_primes(61, 40, 8)), 8),
                                        ((0xFFFFC4001, 0x1FFFFE0001), 64)],
                         ids=["words", "degree"])
def test_plans_past_the_caps(moduli, ell):
    """More than 64 words of magnitude, or l above 32: past the kernel's
    caps (the wrapper refuses such a plan on a card; the plain twin takes
    them on the CPU)."""
    q = int(np.prod([int(m) for m in moduli], dtype=object))
    lo, hi = 1, 1 << (q.bit_length() // ell + 1)         # Δ = floor(q^(1/l))
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if mid ** ell <= q else (lo, mid - 1)
    plan = dd.DecodePlan(moduli, ell, lo)
    assert plan.supported and not plan.kernel_fits()


def test_launch_counters_list_the_decode_kernel():
    counters = fm.launch_counters()
    assert counters[dd.KERNEL] == (dd.decode_residues, "launches")
    assert dd.KERNEL == "pvw_decode"


def test_other_devices_raise():
    """A tensor on neither the CPU nor a card raises before any count."""
    p = params(*CHAINS["toy"])
    z = torch.empty((4, 2, 8), dtype=torch.int64, device="meta")
    calls = dd.decode_residues.calls
    with pytest.raises(ValueError, match="unsupported device"):
        dd.decode_residues(dd.get_plan(p), z)
    assert dd.decode_residues.calls == calls
