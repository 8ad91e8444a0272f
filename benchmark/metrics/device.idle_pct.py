"""Share of a frame's time in which nothing ran on the card:
100 x (1 - busy / wall). Busy is the union of device activity over the
traffic's `trace_frames` whole frames traced after the window
(`measure.trace_summary`); the wall is as many of the window's untraced
frames (their mean time), since tracing slows the host's side of a frame
and not the device's."""


def read(run):
    busy_ms = run.profile()["device_busy_ms"]
    if busy_ms is None or not run.window.frames:
        return None
    return 100.0 * (1.0 - busy_ms / (run.traffic["trace_frames"]
                                     * run.frame_ms()))
