"""The JAX package's four examples (``examples/``) on the port: ``pvw``,
``pvw_valid_dec``, ``pvw_sharded`` and ``interop_exchange``. Each runs as
``python -m pvw_tpu_torch.examples.<name> [--device cpu|cuda]`` (default
``cuda``, which raises without a card) and exits non-zero if a check fails.
"""
