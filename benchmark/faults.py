"""Faults planted in the port's timed path, each of which the comparison
that decides `correct` has to catch:

- `step_returns_state_unchanged`: every bounce step hands back the path
  state it was given;
- `half_the_samples_in_the_mean`: the spp mean is taken over half of each
  pixel's samples, the rest left out;
- `one_chunk_altered`: the radiance of one chunk of rays (the middle one)
  is altered where the frame function produces it.

`with planted(name): ...` runs the block with the fault in place. The
benchmark's own runs never plant one; `control.py --faults` reads them at
a cell's size on the card, and the CPU tests at a tiny one.
"""

from __future__ import annotations

import contextlib
from unittest import mock


def _step_keeps_state():
    from potato_tpu_torch.render import compact, integrator

    def make(*args, **kwargs):
        return lambda state, bounce, ray_ids: state
    return [(integrator, "make_bounce_step", make),
            (compact, "make_bounce_step", make)]


def _half_the_samples():
    from potato_tpu_torch.render import renderer
    real = renderer._to_host

    def to_host(out, width, height, spp, with_aovs):
        # a pixel's samples are consecutive rows, in tiled order or not
        rows = out.color.reshape(-1, 3)[:width * height * spp]
        rows = rows.reshape(width * height, spp, 3)
        half = rows[:, : max(1, spp // 2)]
        rows = half.repeat(1, spp // half.shape[1], 1).reshape(-1, 3)
        color = out.color.clone().reshape(-1, 3)
        color[:rows.shape[0]] = rows
        return real(out._replace(color=color.reshape(out.color.shape)),
                    width, height, spp, with_aovs)
    return [(renderer, "_to_host", to_host)]


def _one_chunk_altered():
    from potato_tpu_torch.render import renderer
    real = renderer._frame_fn

    def frame_fn(*args, **kwargs):
        fn = real(*args, **kwargs)

        def altered(*a):
            out = fn(*a)                  # stacked (chunks, rays, ...)
            color = out.color.clone()
            color[len(color) // 2] += 0.05
            return out._replace(color=color)
        return altered
    return [(renderer, "_frame_fn", frame_fn)]


FAULTS = {"step_returns_state_unchanged": _step_keeps_state,
          "half_the_samples_in_the_mean": _half_the_samples,
          "one_chunk_altered": _one_chunk_altered}


@contextlib.contextmanager
def planted(name: str):
    with contextlib.ExitStack() as stack:
        for owner, attr, fake in FAULTS[name]():
            stack.enter_context(mock.patch.object(owner, attr, fake))
        yield
