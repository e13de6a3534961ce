"""Device selection for the port's entry points.

Every entry point that creates tensors takes ``device=`` and defaults to
``"cuda"``. A CUDA request on a machine without a card raises here: the
port never falls back to the CPU on its own. Pass ``device="cpu"`` to run
on the CPU (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` (str or torch.device) -> torch.device; raises when CUDA
    is requested and ``torch.cuda.is_available()`` is False."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"pvw_tpu_torch: device {str(dev)!r} requested but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU"
        )
    return dev
