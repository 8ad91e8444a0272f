"""Share of the bounce passes that a CUDA graph replay served:
100 x the window's replayed passes / the window's bounce passes, from the
port's program counters `render/integrator.py::pass_counts` (`replayed`,
`passes`, kept on the host). None where the program has no such counters
or ran no pass in the window."""


def _counts():
    from potato_tpu_torch.render import integrator

    counts = getattr(integrator, "pass_counts", None)
    return None if counts is None else (counts.passes, counts.replayed)


def before_window(run):
    run.state["passes_before"] = _counts()


def after_window(run):
    run.state["passes_after"] = _counts()


def read(run):
    before = run.state.get("passes_before")
    after = run.state.get("passes_after")
    if before is None or after is None or after[0] <= before[0]:
        return None
    return 100.0 * (after[1] - before[1]) / (after[0] - before[0])
