"""Path segments of all the window's good frames over the seconds from the
first frame's start to the last frame's return (host clock)."""


def read(run):
    w = run.window
    if not w.good:
        return None
    return sum(f.segments for f in w.good) / w.seconds
