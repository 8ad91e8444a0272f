"""Set-up: from the process's start to the first timed frame (imports, CUDA
context, the kernel library from its build cache, scene records, the port's
scene and accelerator build, and one warm frame of the cell's shapes)."""


def read(run):
    return run.setup_s
