"""The comparison that decides `correct`: a frame of the port against the
reference's frame of the same records, seed and size.

A path tracer's frames agree up to rounding, except where rounding sends a
path another way (a grazed sphere, a hit at t_min): such a pixel is off by
much more than rounding. So each number is a share of pixels (or segments)
that differ, each pixel judged by a fixed tolerance, and each number has a
limit per cell in `limits/<cell>.json`, set from readings of sound runs and
of the control (PERF.md gives them).

Sound frames' off pixels are scattered over the image; a fault confined to
a part of the frame (one chunk of rays: 2^15 rays are 8 192 pixels, 1.7 %
of an 800x600 frame at 4 spp) stays under a whole-frame share but fills
the image rows it covers. So the colour is judged twice: over the frame,
and in its worst band of `BAND_ROWS` image rows.
"""

from __future__ import annotations

import numpy as np

PIXEL_TOL = 2e-3     # a channel further off than this makes the pixel off
COVERAGE_TOL = 1e-6  # coverage is k / spp: any change is a sample that flipped
BAND_ROWS = 8        # image rows in one band of `color_band_off_pct`
NAMES = ("color_off_pct", "color_band_off_pct", "normal_off_pct",
         "coverage_off_pct", "segments_off_pct")


def _off(a, b, tol):
    """(H, W) map of pixels off by more than `tol` in some channel."""
    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    if diff.ndim == 3:
        diff = diff.max(axis=-1)
    return ~(diff <= tol)                             # NaN counts as off


def _off_pct(a, b, tol):
    return 100.0 * float(np.mean(_off(a, b, tol)))


def worst_band_pct(off, rows=BAND_ROWS) -> float:
    """The largest share of off pixels over bands of `rows` image rows
    (the last band may be shorter)."""
    per_row = off.mean(axis=1)
    return 100.0 * float(max(per_row[i:i + rows].mean()
                             for i in range(0, len(per_row), rows)))


def frame_numbers(got, want) -> dict:
    """`got` and `want` have .color, .normal (H, W, 3), .coverage (H, W)
    and .segments."""
    if got.color.shape != want.color.shape:
        return {n: 100.0 for n in NAMES}
    color_off = _off(got.color, want.color, PIXEL_TOL)
    return {
        "color_off_pct": 100.0 * float(np.mean(color_off)),
        "color_band_off_pct": worst_band_pct(color_off),
        "normal_off_pct": _off_pct(got.normal, want.normal, PIXEL_TOL),
        "coverage_off_pct": _off_pct(got.coverage, want.coverage,
                                     COVERAGE_TOL),
        "segments_off_pct": 100.0 * abs(int(got.segments) - int(want.segments))
        / max(int(want.segments), 1),
    }


def worst(readings) -> dict:
    """Each number's largest reading over several frames."""
    return {n: max(r[n] for r in readings) for n in NAMES}


def judge(numbers: dict, limits: dict):
    """(every number within its limit, {name: {"value", "limit"}})."""
    checks = {n: {"value": numbers[n], "limit": limits[n]["limit"]}
              for n in NAMES}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
