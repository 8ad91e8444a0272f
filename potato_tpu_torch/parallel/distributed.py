"""Process-group set-up for the sharded render and training step.

Counterpart of potato_tpu/parallel/distributed.py on torch.distributed. On
each process, as `torchrun --nproc-per-node N script.py` starts it:

    from potato_tpu_torch.parallel import distributed
    backend = distributed.initialize()     # torch's standard variables, or
    backend = distributed.initialize("tcp://10.0.0.1:29500", world_size=8,
                                     rank=i, local_world_size=4)

after which `mesh.make_ray_group()` names this rank's share of the rays
(parallel/shard.py). A single process with nothing configured needs no
call: `initialize()` then does nothing.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from potato_tpu_torch.core.types import resolve_device

# A rank that waits longer than this in the rendezvous or a collective
# raises: a fault on one rank fails the run instead of hanging the others.
DEFAULT_TIMEOUT_S = 600.0


def choose_backend(device_type: str, local_world_size: Optional[int],
                   device_count: int,
                   world_size: Optional[int] = None) -> str:
    """The rule: "nccl" when every rank on this host has a card of its
    own; "gloo" when ranks share a card (NCCL refuses two ranks on one
    device) or run on the CPU.

    `local_world_size` counts the ranks on this host (torchrun's
    LOCAL_WORLD_SIZE). Where it is not known, the world size bounds it: a
    world no larger than the host's cards takes nccl, and a larger one is
    refused (ValueError), since it may be one host of shared cards or
    many hosts of one card each."""
    if device_type != "cuda":
        return "gloo"
    if local_world_size is None:
        if world_size is None or world_size > device_count:
            raise ValueError(
                f"a world of {world_size} ranks and {device_count} cards "
                "on this host: say how many ranks run on this host "
                "(local_world_size, or LOCAL_WORLD_SIZE)")
        local_world_size = world_size
    return "nccl" if local_world_size <= device_count else "gloo"


def rank_device(device="cuda", local_rank: Optional[int] = None
                ) -> torch.device:
    """This rank's device: `cuda:{LOCAL_RANK % device_count}` when asked
    for the card (which raises without one), else the device asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None,
               device="cuda",
               local_world_size: Optional[int] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[str]:
    """Join the process group; returns the backend chosen, or None when
    nothing is configured (one process: nothing to join).

    Explicit arguments win over torch's standard variables: `init_method`
    over MASTER_ADDR/MASTER_PORT (read as "env://"), `world_size` over
    WORLD_SIZE, `rank` over RANK, `local_world_size` over
    LOCAL_WORLD_SIZE (the ranks on this host, for `choose_backend`);
    LOCAL_RANK picks the card. `backend` overrides the rule."""
    dev = rank_device(device)
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None and world_size is None:
        return None
    if local_world_size is None and "LOCAL_WORLD_SIZE" in env:
        local_world_size = int(env["LOCAL_WORLD_SIZE"])
    if backend is None:
        count = torch.cuda.device_count() if dev.type == "cuda" else 0
        backend = choose_backend(dev.type, local_world_size, count,
                                 world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None)
    return backend


def is_coordinator() -> bool:
    """True on the rank that writes images and logs (rank 0, or the only
    process)."""
    return not dist.is_initialized() or dist.get_rank() == 0
