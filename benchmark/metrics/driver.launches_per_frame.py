"""Flash kernel launches a frame: the port's launch counter
(`ops/flash.py::flash_intersect_kernel.launches`) over the window's frames.
The counter counts only launches on the card."""


def _launches():
    from potato_tpu_torch.ops import flash

    return flash.flash_intersect_kernel.launches


def before_window(run):
    run.state["launches_before"] = _launches()


def after_window(run):
    run.state["launches_after"] = _launches()


def read(run):
    n = run.state["launches_after"] - run.state["launches_before"]
    if run.device.type != "cuda" or not run.window.frames or n == 0:
        return None
    return n / len(run.window.frames)
