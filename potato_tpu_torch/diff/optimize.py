"""Inverse rendering: differentiable losses and the texture-optimisation
loop.

Scene parameters (texture texels, colours, material parameters) are fitted
by gradient descent so that the rendered image matches a target, through
the whole path tracer, with checkpoint and resume.

Gradients come from eager autograd. A frame is differentiated chunk by
chunk: each chunk of whole pixels renders, its summed squared error is
scaled by 1/(N*3) and backpropagated at once, and its graph is freed
before the next chunk renders. The sum of the chunks' gradients is the
whole-frame gradient up to float32 summation order, in the memory of one
chunk.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from potato_tpu_torch.core.types import resolve_device
from potato_tpu_torch.render.renderer import (
    DEFAULT_CHUNK,
    check_scene_device,
    make_intersect_fn,
    render_chunk,
)
from potato_tpu_torch.scene.tables import CompiledScene

# Differentiable leaves of SceneTables, by field name. Every one is
# differentiable on every accel, the flash kernel included: the kernel
# detaches only the hit decision (t and winning slot, ops/flash.py), while
# these parameters enter the radiance through material evaluation and
# texture sampling. What is NOT differentiable anywhere is d(hit
# decision)/d(geometry), which none of these fields touch.
DIFFERENTIABLE_FIELDS = (
    "atlas",            # image texture texels
    "t_color",          # solid texture colors
    "m_absorb_color",   # material albedos
    "m_emit_color",     # emission colors
    "m_scatter_param",  # metal fuzz / dielectric IOR
    "bg_color",
)


class RenderLoss:
    """loss(params, ray_ids, target) -> scalar MSE, where `params` is a
    dict {field_name: tensor} substituted into the scene tables.

    target is per PIXEL, (N, 3); ray_ids must cover whole pixels in order.
    Colours are averaged over the spp samples of a pixel before the MSE:
    comparing single rays against pixel means would add an irreducible
    within-pixel variance floor to the loss.

    Calling the loss records the whole frame in one autograd graph;
    `value_and_grad` differentiates it chunk by chunk instead.
    """

    def __init__(self, scene: CompiledScene, chunk_fn: Callable, spp: int,
                 chunk_rays: int):
        self.scene = scene
        self.chunk_fn = chunk_fn
        self.spp = spp
        # rays per chunk of the chunk-by-chunk gradient: whole pixels
        self.chunk_rays = max(spp, chunk_rays // spp * spp)
        self.chunks = 0     # chunks the last value_and_grad took

    def _inputs(self, ray_ids, target):
        dev = self.scene.device
        ids = torch.as_tensor(ray_ids, device=dev).to(torch.int64)
        tgt = torch.as_tensor(target, device=dev).to(torch.float32)
        return ids, tgt.reshape(-1, 3)

    def _pixels(self, params, ids):
        tables = self.scene.tables._replace(**params)
        out = self.chunk_fn(tables, self.scene.camera, ids)
        return out.color.reshape(-1, self.spp, 3).mean(dim=1)

    def __call__(self, params: Dict[str, torch.Tensor], ray_ids, target):
        ids, tgt = self._inputs(ray_ids, target)
        return torch.mean((self._pixels(params, ids) - tgt) ** 2)

    def value_and_grad(self, params: Dict[str, torch.Tensor], ray_ids,
                       target, stamp: Optional[Callable] = None):
        """(loss, {field: gradient}), the frame taken chunk by chunk.

        stamp: optional callable, called with "forward" before each chunk
        renders, "backward" before its backward pass and "done" after it
        (chip_smoke.py records a CUDA event at each)."""
        mark = stamp or (lambda label: None)
        ids, tgt = self._inputs(ray_ids, target)
        leaves = {k: torch.as_tensor(v, device=self.scene.device).detach()
                  .requires_grad_(True) for k, v in params.items()}
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        loss = torch.zeros((), dtype=torch.float32, device=self.scene.device)
        scale = 1.0 / (tgt.shape[0] * 3)
        per = self.chunk_rays // self.spp
        self.chunks = 0
        for p0 in range(0, tgt.shape[0], per):
            mark("forward")
            pixels = self._pixels(leaves, ids[p0 * self.spp:(p0 + per)
                                              * self.spp])
            part = torch.sum((pixels - tgt[p0:p0 + per]) ** 2) * scale
            mark("backward")
            if part.requires_grad:
                got = torch.autograd.grad(part, list(leaves.values()),
                                          allow_unused=True)
                for k, g in zip(leaves, got):
                    if g is not None:
                        grads[k] += g
            loss = loss + part.detach()
            mark("done")
            self.chunks += 1
        return loss, grads


def make_render_loss(scene: CompiledScene, *, width: int, height: int,
                     spp: int, max_bounce: int, seed: int,
                     fields: tuple = ("atlas",),
                     force_plain: bool = False) -> RenderLoss:
    """The render loss over `fields` (see RenderLoss). force_plain runs
    the flash kernel's plain version whatever the device, for
    comparisons."""
    for f in fields:
        assert f in DIFFERENTIABLE_FIELDS, f
    # Optimising m_scatter_param includes the dielectric IOR, whose
    # reflect/refract choice is detached in the sampler: the score-function
    # surrogate keeps the choice-probability term (diff/surrogate.py;
    # forward images unchanged). The scene's feature set skips only
    # material and texture variants it never selects, which changes no
    # value and no gradient.
    chunk_fn = partial(render_chunk,
                       intersect_fn=make_intersect_fn(scene,
                                                      force_plain=force_plain),
                       width=width, height=height, spp=spp,
                       max_bounce=max_bounce, seed=seed,
                       features=scene.features, aovs=False,
                       ior_score="m_scatter_param" in fields)
    return RenderLoss(scene, chunk_fn, spp, DEFAULT_CHUNK)


@dataclass
class OptimizeResult:
    params: Dict[str, np.ndarray]
    losses: List[float] = field(default_factory=list)
    steps_done: int = 0


def optimize_textures(scene: CompiledScene, target: np.ndarray, *,
                      width: int, height: int, spp: int = 2,
                      max_bounce: int = 4, seed: int = 0,
                      fields: tuple = ("atlas",),
                      steps: int = 100, learning_rate: float = 0.05,
                      adam: bool = True,
                      checkpoint_path: Optional[str] = None,
                      checkpoint_every: int = 25,
                      log_every: int = 10,
                      init: Optional[Dict[str, np.ndarray]] = None,
                      metrics=None, device="cuda") -> OptimizeResult:
    """Gradient-descend scene parameters to match `target` (H, W, 3).

    Resumes from `checkpoint_path` if it exists (step counter, params and
    optimizer moments all restored: a crash loses at most
    `checkpoint_every` steps).

    metrics: optional utils.metrics.MetricsLogger (or the POTATO_METRICS
    env path): JSONL events opt_step (step, loss, seconds) and
    opt_checkpoint.

    device: where the scene lives (default the card, which raises without
    one); the scene must have been built there.
    """
    from potato_tpu_torch.utils.metrics import from_env_or

    check_scene_device(scene, resolve_device(device))
    dev = scene.device
    own_metrics = metrics is None        # a POTATO_METRICS file is ours
    metrics = from_env_or(metrics)
    total = width * height * spp
    ray_ids = torch.arange(total, dtype=torch.int64, device=dev)
    target_px = torch.as_tensor(np.asarray(target, np.float32)
                                .reshape(-1, 3), device=dev)

    loss_fn = make_render_loss(scene, width=width, height=height, spp=spp,
                               max_bounce=max_bounce, seed=seed,
                               fields=fields)

    params = {f: getattr(scene.tables, f).detach().clone() for f in fields}
    if init:
        params.update({k: torch.as_tensor(np.asarray(v), device=dev)
                       for k, v in init.items()})
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    start_step = 0
    losses: List[float] = []

    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path, allow_pickle=True) as ckpt:
            start_step = int(ckpt["step"])
            losses = [float(x) for x in ckpt["losses"]]

            def restore(prefix):
                return {k: torch.as_tensor(ckpt[f"{prefix}_{k}"], device=dev)
                        for k in fields}

            params, m, v = restore("p"), restore("m"), restore("v")

    def update(step):
        loss, grads = loss_fn.value_and_grad(params, ray_ids, target_px)
        if not adam:
            return ({k: params[k] - learning_rate * g
                     for k, g in grads.items()}, m, v, loss)
        # Adam written out, in float32 throughout
        b1, b2, eps = 0.9, 0.999, 1e-8
        t = torch.tensor(step + 1, dtype=torch.float32)
        c1 = (1 - b1 ** t).item()
        c2 = (1 - b2 ** t).item()
        new_p, new_m, new_v = {}, {}, {}
        for k, g in grads.items():
            new_m[k] = b1 * m[k] + (1 - b1) * g
            new_v[k] = b2 * v[k] + (1 - b2) * g * g
            mhat = new_m[k] / c1
            vhat = new_v[k] / c2
            new_p[k] = params[k] - learning_rate * mhat / (
                torch.sqrt(vhat) + eps)
        return new_p, new_m, new_v, loss

    def save(step):
        if not checkpoint_path:
            return
        payload = {"step": step, "losses": np.asarray(losses)}
        for prefix, d in (("p", params), ("m", m), ("v", v)):
            payload.update({f"{prefix}_{k}": x.cpu().numpy()
                            for k, x in d.items()})
        tmp = checkpoint_path + ".tmp.npz"
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, checkpoint_path)  # atomic: crash loses <= 1 interval

    try:
        for step in range(start_step, steps):
            t_s = time.perf_counter()
            params, m, v, loss = update(step)
            loss = float(loss)
            losses.append(loss)
            metrics.log("opt_step", step=step, loss=loss,
                        seconds=round(time.perf_counter() - t_s, 4))
            if log_every and (step % log_every == 0 or step == steps - 1):
                print(f"step {step}: loss {loss:.6f}")
            if checkpoint_path and (step + 1) % checkpoint_every == 0:
                save(step + 1)
                metrics.log("opt_checkpoint", step=step + 1)
        save(steps)
    finally:
        if own_metrics:
            metrics.close()

    return OptimizeResult(
        params={k: p.cpu().numpy() for k, p in params.items()},
        losses=losses, steps_done=steps)
