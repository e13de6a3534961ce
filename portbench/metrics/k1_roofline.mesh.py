"""Kernel 1's share of its roofline on rank 0 (recv row 0, kdim block 0)
over the traced rounds, at the shard's shapes: the least time
(``roofline.product_least_s`` on the configuration with k cut to its kdim
block) of c1's product (k rows, noise bound error_bound_1) and c2's bare
product (the recv row's n / recv rows: its bound has no signed digits, so
the shard reads no noise planes and encodes nothing) over the summed device
time of ``fused_scaled_noise_matmul_kernel``."""

from portbench import roofline

KERNEL = "fused_scaled_noise_matmul_kernel"


def read(ctx):
    t, cfg = ctx["trace"], ctx["config"]
    us = t.kernel_us(KERNEL)
    if not us:
        return None
    recv, kdim = cfg["mesh"]
    shard = {**cfg, "k": cfg["k"] // kdim}
    n = cfg["n"]
    least = (roofline.product_least_s(shard, cfg["k"], n, cfg["error_bound_1"], False)
             + roofline.product_least_s(shard, n // recv, n, cfg["error_bound_2"], False))
    return 100 * t.requests * least / (us / 1e6)
