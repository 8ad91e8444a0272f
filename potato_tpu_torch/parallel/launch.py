"""Run a function on local processes that form one process group.

The port's counterpart of the JAX tests' virtual 8-device mesh and of
tools/scaling_harness.py's procs mode:

    from potato_tpu_torch.parallel import launch
    out = launch.spawn(fn, 4, *args, device="cpu")   # fn(group, *args)
    out.result            # what rank 0's fn returned
    launch.dryrun_multichip(2)                        # both paths, the card

Processes start with the spawn method (the parent may hold a CUDA
context) and meet through a file:// rendezvous in a temporary directory,
so no TCP port is taken and concurrent runs cannot collide. Each rank's
device is `parallel/distributed.py::rank_device`; every rank is on this
host, so ranks that share a card join under gloo, by `choose_backend`'s
rule.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from functools import partial
from typing import Any, Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from potato_tpu_torch.core.types import resolve_device
from potato_tpu_torch.parallel.distributed import DEFAULT_TIMEOUT_S, initialize
from potato_tpu_torch.parallel.mesh import RayGroup, make_ray_group
from potato_tpu_torch.parallel.shard import (
    make_sharded_render_fn,
    make_sharded_train_step,
)


class Spawned(NamedTuple):
    result: Any              # what rank 0's function returned
    backend: str             # the process group's backend
    startup: List[dict]      # per rank: seconds from spawn to the rank's
                             # entry (interpreter, torch and the package
                             # imported) and in init_process_group


def spawn(fn: Callable, world: int, *args, device="cuda",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> Spawned:
    """fn(group, *args) on ranks 0..world-1, each a new process; returns
    rank 0's result. `fn` must be importable by name (a module-level
    function). A rank that raises fails the call (the others are
    terminated); a run longer than `timeout_s` is terminated and raises
    TimeoutError, and so does a collective that waits that long."""
    resolve_device(device)
    # CPU ranks share this process's threads: one pool each of its share,
    # not `world` pools of every core spinning against each other
    threads = max(1, torch.get_num_threads() // world)
    with tempfile.TemporaryDirectory(prefix="potato_spawn_") as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(fn, args, world, "file://" + os.path.join(tmp, "rdzv"),
                  device, timeout_s, out, time.time(), threads))
        deadline = time.monotonic() + timeout_s
        while not ctx.join(timeout=0.5):    # raises if a rank failed
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"spawn of {world} ranks passed "
                                   f"{timeout_s} s")
        with open(out, "rb") as f:       # written by rank 0 of this call
            return pickle.load(f)


def _rank_main(rank, fn, args, world, init_method, device, timeout_s, out,
               spawned_at, threads):
    entered = time.time()
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(threads)
    backend = initialize(init_method, world_size=world, rank=rank,
                         device=device, local_world_size=world,
                         timeout_s=timeout_s)
    try:
        group = make_ray_group(device)
        startup = gather_objects({
            "rank": rank, "device": str(group.device),
            "spawn_to_entry_s": entered - spawned_at,
            "init_process_group_s": time.time() - entered}, group)
        result = fn(group, *args)
        if rank == 0:
            with open(out + ".tmp", "wb") as f:
                pickle.dump(Spawned(result, backend, startup), f)
            os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


def in_turn(group: RayGroup, fns: List[Callable]) -> list:
    """[fn(group) for fn in fns]: several rank functions in one spawn."""
    return [fn(group) for fn in fns]


def gather_objects(obj, group: RayGroup) -> list:
    """Every rank's picklable `obj`, in rank order, on every rank."""
    if group.process_group is None:
        return [obj]
    got = [None] * group.world_size
    dist.all_gather_object(got, obj, group=group.process_group)
    return got


# ---------------------------------------------------------------- dry run

def _flagship(assets_dir: Optional[str]):
    """The bunny where `bunny.obj` is in `assets_dir`, else one_triangle
    (the same code paths: triangles, clusters, a sky background), as the
    reference's dry run chooses."""
    from potato_tpu_torch.scene import examples

    if assets_dir and os.path.exists(os.path.join(assets_dir, "bunny.obj")):
        return "bunny", partial(examples.bunny, assets_dir)
    return "one_triangle", examples.one_triangle


def _dryrun_rank(group: RayGroup, assets_dir: Optional[str]) -> dict:
    from potato_tpu_torch.scene import examples

    dev = group.device
    name, make = _flagship(assets_dir)
    scene = make().build(accel="flash", device=dev)
    ids = torch.arange(64 * 64, device=dev)
    out = make_sharded_render_fn(scene, group, width=64, height=64, spp=1,
                                 max_bounce=4, seed=0)(
        scene.tables, scene.camera, ids)
    segments = int(out.segments)
    if segments < ids.shape[0]:
        raise RuntimeError(f"{name}: {segments} segments traced for "
                           f"{ids.shape[0]} camera rays")
    earth = examples.earth(assets_dir).build(accel="flash", device=dev)
    kw = dict(width=8, height=8, spp=2, max_bounce=3, seed=0)
    ids = torch.arange(8 * 8 * 2, device=dev)
    target = make_sharded_render_fn(earth, group, **kw)(
        earth.tables, earth.camera, ids).color
    step = make_sharded_train_step(earth, group, learning_rate=20.0, **kw)
    _, loss = step(torch.full_like(earth.tables.atlas, 0.25), earth.tables,
                   earth.camera, ids, target)
    if not float(loss) > 0.0:
        raise RuntimeError(f"earth: train step loss {float(loss)}")
    return {"flagship": name, "segments": segments, "loss": float(loss)}


def dryrun_multichip(world: int, device="cuda",
                     assets_dir: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> dict:
    """Both scale-out paths on `world` processes, as the reference's
    `__graft_entry__.dryrun_multichip`: (1) a sharded 64x64 flash render
    of the flagship mesh scene; (2) one sharded training step on the earth
    scene (flash; its `earthmap.tga` is read from `assets_dir`)."""
    done = spawn(_dryrun_rank, world, assets_dir, device=device,
                 timeout_s=timeout_s)
    r = done.result
    print(f"dryrun_multichip({world}): {done.backend}, 64x64 flash render "
          f"of {r['flagship']} ok, {r['segments']} segments; one sharded "
          f"train step ok, loss={r['loss']:.6f}")
    return r
