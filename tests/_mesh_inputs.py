"""The served mesh's inputs in its tests (``MeshService``'s input function,
loaded by path in every rank): the reference preset's chain and bounds at
a few parties, secret coefficients and scalars from a seed, and faults
planted in a rank's process on request."""

import numpy as np
import torch

from pvw_tpu_torch.params import PvwParameters, presets

N, K, DEALERS, SLOTS = 8, 32, 8, 2


def params() -> PvwParameters:
    """``secure_128_reference``'s chain, l, variance and bounds (1, 1172385),
    whose c2 takes the bake route at kdim 2, at n = 8, k = 32."""
    p = presets.secure_128_reference(N)
    return PvwParameters(N, K, p.l, list(p.ring.moduli), p.secret_variance,
                         p.error_bound_1, p.error_bound_2)


def coefficients(seed: int) -> torch.Tensor:
    """Every party's secret coefficients, int32 [N, K, l] in [-20, 20]."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(-20, 21, (N, K, params().l), generator=gen, dtype=torch.int32)


def pool(seed: int) -> list[np.ndarray]:
    """The scalars of each slot, u64 [DEALERS, N]."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 2**64 - 1, size=(DEALERS, N), dtype=np.uint64, endpoint=True)
            for _ in range(SLOTS)]


def inputs(view) -> dict:
    seed = view.args["seed"]
    plant = view.args.get("plant")
    if plant == "plain_sum":
        from pvw_tpu_torch.parallel import sharding

        # the partials added without reducing mod q
        sharding._modsum_gathered = lambda parts, ring, device: sum(p.to(device) for p in parts)
    if plant == "fail" and view.rank == view.args["rank"]:
        from pvw_tpu_torch.parallel import sharding

        def fails(*args, **kwargs):
            raise RuntimeError("a planted failure of this rank's products")

        sharding._shard_products = fails
    if plant == "launches":
        from pvw_tpu_torch.ops import fused_modmat as fm

        # each rank's kernel 1 counted as launched rank + 1 times
        fn, attr = fm.launch_counters()[fm.KERNEL]
        setattr(fn, attr, view.rank + 1)
    c = coefficients(seed)
    return {"coeffs": {r: c[lo:hi] for r, (lo, hi) in view.rows.items()},
            "pool": [{r: s[:, lo:hi] for r, (lo, hi) in view.rows.items()} for s in pool(seed)],
            "keep_cols": view.args.get("keep_cols")}
