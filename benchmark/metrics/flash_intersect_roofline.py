"""The flash kernel's share of its roofline over one whole frame's
launches: the least time of each launch (`measure.kernel_bound_ms`: the
pair tests its queues need and the pairs that can hit, over the published
float32 peak; every input read once and every output written once, over
the memory rate) summed, over the launches' device times behind a spinning
kernel (`measure.device_ms`) summed.

The launches are the cell's own: their inputs are captured from a frame
rendered through `render()` after the window. The count of pair tests
follows the port's queue design (its visits per termination group, the
child and parent cluster sizes W and K), and the pairs that can hit are
counted by the port's plain version of the kernel."""

from types import SimpleNamespace

import torch

from benchmark import measure


def read(run):
    if run.device.type != "cuda":
        return None
    from potato_tpu_torch.ops import flash

    real = flash.flash_intersect_kernel
    captured = []

    def capturing(packed_rays, queues, tri_flat, sph_feats, block=flash.R,
                  has_sph=False, visits=None, group=None):
        captured.append((packed_rays, queues, tri_flat, sph_feats, block,
                         has_sph, group))
        return real(packed_rays, queues, tri_flat, sph_feats, block, has_sph,
                    visits=visits, group=group)

    # the kernel counts its launches on the name it is called by
    capturing.launches = real.launches
    flash.flash_intersect_kernel = capturing
    try:
        run.render_frame()
    finally:
        flash.flash_intersect_kernel = real
        real.launches = capturing.launches
    if not captured:
        return None

    bound_ms = spent_ms = 0.0
    dev = run.device
    for rays, queues, tri, sph, block, has_sph, group in captured:
        group = flash.resolve_group(block, group)
        args = (rays, queues, tri, sph, block, has_sph)
        spent_ms += measure.device_ms(lambda: real(*args, group=group))
        bp = rays.shape[1]
        visits = torch.zeros((bp // group, 3), dtype=torch.int32, device=dev)
        real(*args, visits=visits, group=group)
        can_hit = torch.zeros((bp // group, 2), dtype=torch.int64, device=dev)
        plain_visits = torch.zeros_like(visits)
        flash.flash_intersect_plain(*args, visits=plain_visits, group=group,
                                    can_hit=can_hit)
        visits_block = torch.zeros((bp // block, 3), dtype=torch.int32,
                                   device=dev)
        flash.flash_intersect_plain(*args, visits=visits_block, group=block)
        inp = SimpleNamespace(packed_rays=rays, queues=queues,
                              has_sph=has_sph)
        bound_ms += measure.kernel_bound_ms(
            tri, sph, inp, visits, can_hit, visits_block, group, block,
            flash.W, flash.K)["ms"]
    return 100.0 * bound_ms / spent_ms
