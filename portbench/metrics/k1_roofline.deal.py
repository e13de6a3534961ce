"""Kernel 1's share of its roofline over the traced rounds: the least time
of each round's c1 and c2 products (``roofline.round_products_least_s``)
over the summed device time of ``fused_scaled_noise_matmul_kernel``."""

from portbench import roofline

KERNEL = "fused_scaled_noise_matmul_kernel"


def read(ctx):
    t = ctx["trace"]
    us = t.kernel_us(KERNEL)
    if not us:
        return None
    return 100 * t.requests * roofline.round_products_least_s(ctx["config"]) / (us / 1e6)
