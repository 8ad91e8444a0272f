"""The uniform draws of the render path: on a card one launch of the
hand-written Threefry-2x32 kernel, csrc/threefry_uniforms.cu, a draw.

`uniforms` draws every stream of a draw at once: a CUDA tensor of ids
launches the kernel (`threefry_uniforms_kernel`) or raises; a CPU tensor
takes the plain version, core/rng.py::uniforms_plain. Both give the same
bits. `draw_counts` counts the lanes x streams each drew and the kernel's
launches.
"""

from __future__ import annotations

import ctypes

import torch

from potato_tpu_torch.core import rng as prng
from potato_tpu_torch.ops._build import build_info, load_library

KERNEL_ROUNDS = (prng.RENDER_ROUNDS, 20)
KERNEL_MAX_STREAMS = 2


class DrawCounts:
    """Program counter of the uniform draws, kept on the host (no sync):
    the lanes x streams that the kernel (`kernel`) and the plain version
    (`plain`) drew, and the kernel's `launches`. A replayed CUDA graph adds
    what its capture counted (render/bounce_graphs.py), so the counts read
    the same with and without graphs."""

    def __init__(self):
        self.kernel = 0
        self.plain = 0
        self.launches = 0

    def add(self, kernel: int = 0, plain: int = 0, launches: int = 0):
        self.kernel += kernel
        self.plain += plain
        self.launches += launches

    def snapshot(self):
        return self.kernel, self.plain, self.launches


draw_counts = DrawCounts()


def uniforms(seed, bounce, streams, ids, rounds: int = prng.RENDER_ROUNDS):
    """The float32 uniforms in [0, 1) of one draw, (2 * len(streams),
    *ids.shape), as `prng.uniforms_plain` defines them. A CUDA tensor of
    ids launches the kernel once, for all the streams, or raises; a CPU
    tensor takes `prng.uniforms_plain`."""
    if isinstance(ids, torch.Tensor) and ids.device.type != "cpu":
        return threefry_uniforms_kernel(seed, bounce, streams, ids, rounds)
    out = prng.uniforms_plain(seed, bounce, streams, ids, rounds)
    draw_counts.add(plain=out.numel() // 2)
    return out


_lib = None


def _library():
    """The compiled kernel library, built at first use."""
    global _lib
    if _lib is None:
        lib = load_library("threefry_uniforms")
        p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        lib.threefry_uniforms_launch.argtypes = [
            p, i, i,             # ids, lanes, rounds
            u, u, p, p,          # key words by value, or through pointers
            u, p, i,             # bounce by value, or its pointer; per lane
            i, u, u,             # streams, the two streams
            p, p]                # out, stream
        lib.threefry_uniforms_launch.restype = i
        _lib = lib
    return _lib


def load_kernel_library() -> dict:
    """Load the kernel library now, building it first if its current
    source has not been built; returns how it was had (`_build.build_info`
    of it: "path", "seconds", "log")."""
    _library()
    return build_info["threefry_uniforms"]


def _kernel_word(x, name, device, shapes):
    """(value, pointer) of a word the kernel reads: a python int by value
    (its low 32 bits), a contiguous int64 tensor on `device` of one of
    `shapes` through its pointer."""
    if not isinstance(x, torch.Tensor):
        return int(x) & prng._M32, None
    if x.device != device or x.dtype != torch.int64 \
            or tuple(x.shape) not in shapes or not x.is_contiguous():
        raise ValueError(
            f"threefry_uniforms_kernel: {name} must be a python int or a "
            f"contiguous int64 tensor on {device} of shape "
            f"{' or '.join(str(s) for s in shapes)}; got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}")
    return 0, x.data_ptr()


def threefry_uniforms_kernel(seed, bounce, streams, ids,
                             rounds: int = prng.RENDER_ROUNDS):
    """`uniforms` in one launch of the hand-written kernel,
    csrc/threefry_uniforms.cu, counted in `draw_counts` (`kernel`,
    `launches`). Raises on what the kernel does not take: ids that are
    not a contiguous int64 CUDA tensor; a key word or bounce tensor on
    another device, of another dtype or shape; a round count other than 13
    or 20; no stream or more than KERNEL_MAX_STREAMS."""
    if not isinstance(ids, torch.Tensor) or ids.dtype != torch.int64 \
            or not ids.is_contiguous():
        raise ValueError("threefry_uniforms_kernel: ids must be a "
                         "contiguous int64 tensor")
    dev = ids.device
    if ids.numel() >= 1 << 31:
        raise ValueError("threefry_uniforms_kernel: at most 2^31 - 1 ids")
    if rounds not in KERNEL_ROUNDS:
        raise ValueError(f"threefry_uniforms_kernel: rounds must be one of "
                         f"{KERNEL_ROUNDS}, got {rounds}")
    streams = tuple(int(s) for s in streams)
    if not 1 <= len(streams) <= KERNEL_MAX_STREAMS:
        raise ValueError(f"threefry_uniforms_kernel: 1 to "
                         f"{KERNEL_MAX_STREAMS} streams, got {len(streams)}")
    k0, k1 = prng._key_words(seed)
    k0_value, k0_ptr = _kernel_word(k0, "key word 0", dev, [()])
    k1_value, k1_ptr = _kernel_word(k1, "key word 1", dev, [()])
    lane_shape = tuple(ids.shape)
    b_value, b_ptr = _kernel_word(bounce, "bounce", dev, [(), lane_shape])
    per_lane = isinstance(bounce, torch.Tensor) and bounce.dim() > 0
    if dev.type != "cuda":
        raise ValueError(f"threefry_uniforms_kernel: ids must lie on a "
                         f"CUDA device, not {dev}")
    out = torch.empty((2 * len(streams),) + lane_shape, dtype=torch.float32,
                      device=dev)
    n = ids.numel()
    if n == 0:
        return out
    with torch.cuda.device(dev):
        err = _library().threefry_uniforms_launch(
            ids.data_ptr(), n, rounds, k0_value, k1_value, k0_ptr, k1_ptr,
            b_value, b_ptr, int(per_lane), len(streams),
            streams[0] & prng._M32, streams[-1] & prng._M32, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"threefry_uniforms kernel launch failed: CUDA error {err}")
    draw_counts.add(kernel=n * len(streams), launches=1)
    return out
