"""Multi-device backends, the counterparts of ``pvw_tpu.parallel``.

- :mod:`.sharding`: a (recv, kdim) :class:`~.sharding.Mesh`, receivers
  row-sharded, the k contraction split with a gather and a modular add;
- :mod:`.limb_parallel`: the RNS limb axis split across devices, no
  collectives;
- :mod:`.grid`: limb groups x the (recv, kdim) mesh;
- :mod:`.data_parallel`: the dealer (batch) axis split across devices, no
  collectives, bit-identical to the single-device encryption under v3k;
- :mod:`.multiprocess`: the (recv, kdim) mesh across processes on
  ``torch.distributed`` (gloo on the CPU and where ranks share a card, NCCL
  with a card a rank), every rank checking its shards byte for byte.

All but ``multiprocess`` run their shards one after another in one
process, on each shard's device; devices may repeat.
"""
from .sharding import (
    Mesh,
    make_mesh,
    encrypt_batch_sharded,
    decrypt_party_shares_sharded,
)
from .limb_parallel import (
    LimbShardedCiphertext,
    decrypt_party_shares_limb_parallel,
    encrypt_batch_limb_parallel,
    limb_partition,
)
from .grid import (
    GridShardedCiphertext,
    decrypt_party_shares_grid,
    encrypt_batch_grid,
)
from .data_parallel import (
    DealerShardedCiphertext,
    encrypt_batch_data_parallel,
)

__all__ = [
    "DealerShardedCiphertext",
    "encrypt_batch_data_parallel",
    "Mesh",
    "make_mesh",
    "encrypt_batch_sharded",
    "decrypt_party_shares_sharded",
    "LimbShardedCiphertext",
    "decrypt_party_shares_limb_parallel",
    "encrypt_batch_limb_parallel",
    "GridShardedCiphertext",
    "decrypt_party_shares_grid",
    "encrypt_batch_grid",
    "limb_partition",
]
