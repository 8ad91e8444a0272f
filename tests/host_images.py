"""Traversal-order rows and the host images the renderer makes of them,
checked against the unswizzle as the renderer once ran it. Shared by
tests/test_torch_render.py (CPU) and tests/test_torch_next_week.py (the
card); imports no JAX.
"""

import numpy as np
import torch

from potato_tpu_torch.render import camera as tcamera
from potato_tpu_torch.render import renderer as trenderer
from potato_tpu_torch.render.integrator import TraceResult


def scatter_then_mean(rows, width, height, spp, channels):
    """The unswizzle as the renderer once ran it: scatter the traversal
    rows to their ray ids through the host permutation, then average."""
    total = width * height * spp
    rows = rows[:total]
    if tcamera._tiles_apply(width, height):
        flat = torch.empty_like(rows)
        flat[torch.from_numpy(
            tcamera.tile_unswizzle_perm(width, height, spp))] = rows
        rows = flat
    return rows.reshape((height, width, spp) + channels).mean(dim=2).numpy()


def traversal_rows(width, height, spp, chunk, device, strided=False):
    """A stacked TraceResult as a driver returns it: (chunks, chunk, ...)
    rows, those past the frame's end filled with garbage; `strided` gives
    the pool driver's views into one (rows, 8) buffer."""
    total = width * height * spp
    chunks = -(-total // chunk)
    g = torch.Generator().manual_seed(width * 131 + height * 7 + spp)
    buf = torch.randn(chunks * chunk, 8, generator=g)
    buf[:, 6] = (buf[:, 6] > 0).to(torch.float32)
    buf[total:] = 1e30
    buf = buf.to(device)
    if strided:
        return TraceResult(
            color=buf[:, 0:3], aov_normal=buf[:, 3:6],
            aov_hit=buf[:, 6] > 0.5,
            segments=torch.tensor(total, device=device))
    stack = buf.reshape(chunks, chunk, 8)
    return TraceResult(
        color=stack[..., 0:3].contiguous(),
        aov_normal=stack[..., 3:6].contiguous(),
        aov_hit=stack[..., 6] > 0.5,
        segments=torch.full((chunks,), total // chunks, device=device))


def assert_host_images_bit_equal(width, height, spp, chunk, device,
                                  strided=False):
    """`renderer._to_host` on `device` against `scatter_then_mean` on the
    CPU, bit for bit, for colour, normal and coverage."""
    out = traversal_rows(width, height, spp, chunk, device, strided)
    got = trenderer._to_host(out, width, height, spp, with_aovs=True)
    cpu = TraceResult(*(x.cpu() for x in out))
    for name, rows, channels in (
            ("color", cpu.color.reshape(-1, 3), (3,)),
            ("normal", cpu.aov_normal.reshape(-1, 3), (3,)),
            ("coverage", cpu.aov_hit.reshape(-1).to(torch.float32), ())):
        want = scatter_then_mean(rows, width, height, spp, channels)
        have = getattr(got, name)
        assert have.shape == want.shape == (height, width) + channels
        assert np.array_equal(have, want), (name, width, height, spp)
    assert got.segments == int(out.segments.sum())
