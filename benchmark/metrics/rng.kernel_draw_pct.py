"""Share of the window's uniform draws that the hand-written Threefry
kernel made: 100 x kernel draws / all draws, each counted in lanes x
streams, from the port's program counter `ops/rng_kernel.py::draw_counts`
(`kernel`, `plain`, kept on the host; a replayed CUDA graph adds the draws
its capture made). None where the program has no such counter or drew
nothing in the window.

A draw on a card has no plain fallback (the kernel or an error), so on a
card the share reads 100 wherever the program has the kernel: it guards
the path, and does not move with the speed."""


def _counts():
    try:
        from potato_tpu_torch.ops import rng_kernel
    except ImportError:
        return None
    counts = getattr(rng_kernel, "draw_counts", None)
    return None if counts is None else (counts.kernel, counts.plain)


def before_window(run):
    run.state["draws_before"] = _counts()


def after_window(run):
    run.state["draws_after"] = _counts()


def read(run):
    before = run.state.get("draws_before")
    after = run.state.get("draws_after")
    if before is None or after is None:
        return None
    kernel, plain = (a - b for a, b in zip(after, before))
    if kernel + plain <= 0:
        return None
    return 100.0 * kernel / (kernel + plain)
