"""Share of the lanes handed to the intersector that carried a live path:
100 x the window's path segments / the lanes the bounce passes handed to
the port's flash intersector over the window (its counter
`ops/flash.py::intersect_flash.lanes`, read from tensor shapes on the
host). None where the program has no such counter."""


def _lanes():
    from potato_tpu_torch.ops import flash

    return getattr(flash.intersect_flash, "lanes", None)


def before_window(run):
    run.state["lanes_before"] = _lanes()


def after_window(run):
    run.state["lanes_after"] = _lanes()


def read(run):
    before = run.state.get("lanes_before")
    after = run.state.get("lanes_after")
    if before is None or after is None or after <= before:
        return None
    return 100.0 * sum(f.segments for f in run.window.frames) / (after - before)
