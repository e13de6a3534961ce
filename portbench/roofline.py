"""The yardstick of the kernels' roofline shares: published H100 SXM peaks
and the work of each kernel computed from a configuration's own sizes.

Frozen copies of ``chip_smoke.contraction_bound`` and ``prescale_bound``
without their INT32 term, whose divisor is an assumed issue rate (the
measured IMAD rate is 0.48 of it): only the published int8 and HBM peaks
count here. A least time is the larger of the int8 digit products at the
int8 rate and the bytes at the HBM rate; each input byte is read once and
each output byte written once.
"""

from __future__ import annotations

INT8_OPS_PER_S = 1.979e15     # dense int8 tensor-core rate, NVIDIA H100 SXM data sheet
HBM_BYTES_PER_S = 3.35e12     # HBM3 bandwidth, same sheet
SIGNED_DIGIT_MAX = (127, 32639)


def signed_digits(bound: int) -> int:
    """Signed 8-bit digits of values up to ``bound`` (0: too wide)."""
    return next((i + 1 for i, b in enumerate(SIGNED_DIGIT_MAX) if bound <= b), 0)


def cbd_bound(variance: float) -> int:
    return 1 if abs(float(variance) - 0.5) < 1e-6 else 2 * int(variance)


def num_digits(cfg: dict) -> int:
    """Signed 8-bit digits a residue of the configuration's widest modulus
    takes: the least nd with (q - 1) >> 8 (nd - 1) <= 126, the top digit
    and its carry below 128."""
    nd = 1
    while (max(cfg["moduli"]) - 1) >> (8 * (nd - 1)) > 126:
        nd += 1
    return nd


def least_s(int8_macs: float, nbytes: float) -> float:
    return max(2 * int8_macs / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def product_least_s(cfg: dict, rows: int, dealers: int, noise_bound: int,
                    encode: bool) -> float:
    """Kernel 1 on one product: lhs digit planes [L, l, rows, k nd] against
    the scaled band [L, l, nd, k nd, d], the noise planes where the bound
    has signed digits, the scalars where it encodes, residues out."""
    L, l, k, nd = len(cfg["moduli"]), cfg["l"], cfg["k"], num_digits(cfg)
    macs = L * l * rows * k * dealers * nd * nd
    nbytes = (L * l * rows * k * nd + L * l * nd * k * nd * dealers
              + l * signed_digits(noise_bound) * rows * dealers
              + (8 * rows * dealers if encode else 0) + 8 * L * l * rows * dealers)
    return least_s(macs, nbytes)


def round_products_least_s(cfg: dict) -> float:
    """Both products of a round of n dealers: c1 (rows k) and c2 (rows n)."""
    n = cfg["n"]
    return (product_least_s(cfg, cfg["k"], n, cfg["error_bound_1"], False)
            + product_least_s(cfg, n, n, cfg["error_bound_2"], True))


def prescale_least_s(cfg: dict, dealers: int) -> float:
    """Kernel 4 on a round's r: the signed NTT of the CBD coefficients by
    int8 digit products and the scaled-digit band written."""
    L, l, k, nd = len(cfg["moduli"]), cfg["l"], cfg["k"], num_digits(cfg)
    jr = signed_digits(cbd_bound(cfg["secret_variance"]))
    groups = L * l * k * dealers
    return least_s(groups * (nd + jr - 1) * l * jr, groups * nd * nd + k * dealers * l * 4)
