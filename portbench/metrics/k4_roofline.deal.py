"""Kernel 4's share of its roofline over the traced rounds: the least time
of each round's r-stage (``roofline.prescale_least_s``, n dealers) over the
summed device time of ``ntt_prescale_band_kernel``."""

from portbench import roofline

KERNEL = "ntt_prescale_band_kernel"


def read(ctx):
    t = ctx["trace"]
    us = t.kernel_us(KERNEL)
    if not us:
        return None
    cfg = ctx["config"]
    return 100 * t.requests * roofline.prescale_least_s(cfg, cfg["n"]) / (us / 1e6)
