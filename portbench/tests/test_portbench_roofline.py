"""The frozen work counts against hand-computed values."""

import json

import pytest
from pb_small import REPO

from portbench import roofline


def cfg(name):
    return json.loads((REPO / "portbench" / "configs" / f"{name}.json").read_text())


def test_t256_c2_product():
    c = cfg("t256-n1024")
    # 17 limbs x 16 slots x 1024 rows x 512 k x 1024 dealers x 8^2 digit products
    macs = 17 * 16 * 1024 * 512 * 1024 * 64
    assert macs == 9_345_848_836_096
    nbytes = (17 * 16 * 1024 * 512 * 8 + 17 * 16 * 8 * 512 * 8 * 1024
              + 16 * 1 * 1024 * 1024 + 8 * 1024 * 1024 + 8 * 17 * 16 * 1024 * 1024)
    want = max(2 * macs / 1.979e15, nbytes / 3.35e12)
    assert want == pytest.approx(9.445e-3, rel=1e-3)                 # operations bound it
    assert roofline.product_least_s(c, 1024, 1024, 50, True) == want


def test_ref128_r_stage():
    c = cfg("ref128-n1024")
    groups = 4 * 8 * 1024 * 1024                  # L l k d
    nbytes = groups * 8 * 8 + 1024 * 1024 * 8 * 4
    macs = groups * (8 + 1 - 1) * 8 * 1                                # jr = 1 at |r| <= 20
    want = max(2 * macs / 1.979e15, nbytes / 3.35e12)
    assert want == nbytes / 3.35e12 == pytest.approx(0.6510e-3, rel=1e-3)
    assert roofline.prescale_least_s(c, 1024) == want


def test_round_is_both_products():
    c = cfg("ref128-n1024")
    c1 = roofline.product_least_s(c, 1024, 1024, 1, False)
    c2 = roofline.product_least_s(c, 1024, 1024, 1172385, True)   # residue route: no planes
    assert c1 == pytest.approx(2.2226e-3, rel=1e-3)
    assert roofline.round_products_least_s(c) == c1 + c2
    assert roofline.signed_digits(127) == 1 and roofline.signed_digits(32639) == 2
    assert roofline.signed_digits(32640) == 0
