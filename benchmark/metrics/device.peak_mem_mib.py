"""Peak device memory allocated over the window, in MiB
(`torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`)."""

import torch


def before_window(run):
    if run.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(run.device)


def after_window(run):
    if run.device.type == "cuda":
        run.state["peak_window"] = torch.cuda.max_memory_allocated(run.device)


def read(run):
    peak = run.state.get("peak_window")
    return None if peak is None else peak / 2 ** 20
