"""The ray group: the ranks that split the ray axis between them.

Counterpart of potato_tpu/parallel/mesh.py's one-axis device mesh. Rays
are independent, so one data-parallel axis is the whole story: rank r of
a world of n traces the r-th contiguous n-th of a frame's ray ids.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from potato_tpu_torch.parallel.distributed import rank_device


@dataclass(frozen=True)
class RayGroup:
    """This process's place on the ray axis."""

    rank: int
    world_size: int
    device: torch.device
    process_group: Optional[dist.ProcessGroup] = None  # None: one process


def make_ray_group(device="cuda") -> RayGroup:
    """The ray group of the initialised process group (the whole world),
    or a world of one when none was initialised (parallel/distributed.py's
    `initialize` did nothing)."""
    dev = rank_device(device)
    if not dist.is_initialized():
        return RayGroup(rank=0, world_size=1, device=dev)
    pg = dist.group.WORLD
    return RayGroup(rank=dist.get_rank(pg), world_size=dist.get_world_size(pg),
                    device=dev, process_group=pg)
