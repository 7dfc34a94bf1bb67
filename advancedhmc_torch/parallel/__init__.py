"""Chain-parallel scale-out: one process per GPU under `torch.distributed`."""

from .mesh import (
    CHAIN_AXIS,
    chain_shard_of,
    distributed_init,
    mesh_of_all_devices,
    shard_hmc_state,
    sharded,
)

__all__ = [
    "CHAIN_AXIS",
    "chain_shard_of",
    "distributed_init",
    "mesh_of_all_devices",
    "shard_hmc_state",
    "sharded",
]
