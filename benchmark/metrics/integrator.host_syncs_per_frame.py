"""Host-device synchronisations of one whole frame through `render()`
(after the window), as torch's sync debug mode reports them."""

from benchmark import measure


def read(run):
    if run.device.type != "cuda":
        return None
    return measure.count_syncs(run.render_frame)
