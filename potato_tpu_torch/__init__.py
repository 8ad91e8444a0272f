"""potato_tpu_torch: the path tracer on PyTorch, with its intersection
kernel written in CUDA C++ for Hopper.

Module for module the counterpart of the JAX package `potato_tpu`
(`core/`, `io/`, `scene/`, `ops/`, `render/`, `diff/`), which stays in the
repository as the reference. This package imports `torch` and numpy only. Every entry
point takes a `device` argument that defaults to ``"cuda"`` and raises
when no card is present; pass ``device="cpu"`` to run the plain PyTorch
version of the kernel (tests do).
"""

__version__ = "0.1.0"
