"""Chain parallelism over processes: one process per GPU.

PyTorch counterpart of `advancedhmc_tpu/parallel/mesh.py`. In JAX the
chain axis of one program is sharded over a device mesh and XLA inserts
the collectives. Here each GPU runs its own process under
`torch.distributed`, and a mesh is a one-dimensional `DeviceMesh` whose
one dimension is named `chains`: rank r of W holds the chains
[r·C/W, (r+1)·C/W) of every chain-major tensor (the chain count must
divide evenly), and the values that the chains share (a cross-chain
adaptation state, the generator's state) are whole and identical on
every rank. `sample(mesh=...)` makes the mesh's block known to the
package (`utils.chain_shard`): the per-chain draws, the loop's exits and
the cross-chain reductions then follow it (see `utils`).

`chain_sharding` and `replicated` have no counterpart. In JAX they name a
placement (`NamedSharding`) that `device_put` gives a global array. The
port has no global array: a process holds plain tensors, its own rows of
a chain-major value (`shard_hmc_state`, `utils.chain_block`) or the whole
of a shared one, so a placement is not an object here.

Launch one process per GPU with `torchrun --nproc_per_node=N script.py`
(each calls `distributed_init()`, which reads torchrun's environment), or
pass `init_method`, `world_size` and `rank` to `distributed_init`
yourself. Without a process group, `mesh_of_all_devices()` starts a world
of one process on the caller's device.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..checkpoint import _flatten
from ..utils import ChainShard, chain_block, chain_shard

CHAIN_AXIS = "chains"


def distributed_init(**kwargs):
    """Join (or start) the process group: `torch.distributed.
    init_process_group(**kwargs)`, with NCCL where CUDA is available and
    gloo on the CPU unless `backend` is given. Under NCCL the process's
    GPU is set to its local rank (`LOCAL_RANK`, else its rank) modulo the
    GPUs present. Does nothing if a group already exists; every other
    failure (a bad address, a timeout, a wrong world size) is raised."""
    if dist.is_initialized():
        return
    _init_group(kwargs)
    if dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def _init_group(kwargs):
    kwargs.setdefault("backend",
                      "nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(**kwargs)


def mesh_of_all_devices(n_devices: Optional[int] = None,
                        axis_name: str = CHAIN_AXIS):
    """The 1-D mesh over every process of the group (one GPU each; under
    gloo, processes on the CPU or sharing a GPU). Without a group, a world
    of one process on the caller's device is started first (NCCL where
    CUDA is available, else gloo): the current CUDA device is left as it
    is, and the shard's collectives run there. `n_devices`, if given, must
    be the world size: a process outside the mesh would hold no chains."""
    if not dist.is_initialized():
        _init_group(dict(store=dist.HashStore(), rank=0, world_size=1))
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the mesh spans every process of the group "
                         f"({world}), not {n_devices}")
    from torch.distributed.device_mesh import DeviceMesh

    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, list(range(world)),
                      mesh_dim_names=(axis_name,))


def chain_shard_of(mesh, axis_name: str = CHAIN_AXIS) -> ChainShard:
    """This process's block of the chains on `mesh` (a 1-D mesh)."""
    group = mesh.get_group(axis_name)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend(group) == "nccl" else torch.device("cpu"))
    return ChainShard(rank=mesh.get_local_rank(axis_name),
                      world=mesh.size(), group=group, device=device)


def sharded(mesh, axis_name: str = CHAIN_AXIS):
    """A context in which the package's phase functions (`init_state`,
    `fused_draw_phase`, `experimental.fused_draw_phase_ragged`, ...) run
    on this rank's block of the chains of `mesh`, as inside
    `sample(mesh=...)`: give them this rank's rows of a state (a sharded
    `final_state`, or `shard_hmc_state`'s) and a generator in the same
    state on every rank. Their outputs keep this rank's rows."""
    return chain_shard(chain_shard_of(mesh, axis_name))


def shard_hmc_state(state, mesh, per_chain_adapt: bool,
                    axis_name: str = CHAIN_AXIS):
    """This rank's block of a whole-batch `HMCState`: every tensor of the
    phase points with an axis keeps its rows of the chains, and so do the
    metric and the adaptation state when they are per chain
    (`per_chain_adapt`); shared ones, and 0-d leaves, are kept whole (they
    are identical on every rank)."""
    def rows(tree):
        leaves, rebuild = _flatten(tree)
        return rebuild([chain_block(x) if isinstance(x, torch.Tensor)
                        and x.dim() >= 1 else x for _, x in leaves])

    with sharded(mesh, axis_name):
        z = rows(state.z)
        if not per_chain_adapt:
            return type(state)(iteration=state.iteration, z=z,
                               metric=state.metric, adapt=state.adapt)
        return type(state)(iteration=state.iteration, z=z,
                           metric=rows(state.metric), adapt=rows(state.adapt))
