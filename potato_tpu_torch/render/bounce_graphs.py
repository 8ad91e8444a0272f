"""A bounce pass replayed as two CUDA graphs around the flash kernel.

A pass of the bounce loop (integrator.make_bounce_step) is hundreds of
small eager ops over fixed shapes, and on a card the host's dispatch of them
(~10 us each) is most of a pass: the card idles ~90 % of a frame. Every op
of a pass has a shape fixed by the lane count and no control flow that
depends on the data, so a pass variant is captured once and replayed:

  graph A   ops/flash.py::prepare_flash over the state's rays: the dense
            sphere test and its fold into t_max, the packed ray rows, the
            triangle and sphere block queues
  kernel    ops/flash.py::flash_hits, launched eagerly on copies of what
            graph A wrote (a wrapper of `flash_intersect_kernel` keeps each
            launch's own inputs, never the graph's buffers), so its launch
            counter and every reader of it see each pass
  graph B   flash_epilogue and the rest of the pass (integrator.advance),
            which writes the next state

The host then issues some 40 calls a pass: the state copied into the
graphs' input buffers, the two replays, the kernel, the copies out. The
replays run the same kernels on the same data as the eager pass, so the
bits are the same. Per-pass values live in device buffers the graphs read:
the seed's two 32-bit key words and the bounce number, refilled by a
launch, not a host copy; graph B's Threefry kernel reads them through
pointers (ops/rng_kernel.py).

The graphs are kept per scene (keyed on its accelerator's triangle table,
and dropped when that tensor is freed), at most MAX_VARIANTS variants a
scene, all in one memory pool, since no two run at once. A variant is one
tables object, lane count, feature set, `ior_score` and whether the pass
writes the AOVs. Its first pass runs eagerly (it warms every kernel up),
its second captures. On the CPU a GraphedStep runs graph A's and graph
B's bodies eagerly through the same buffers (tests/test_torch_graphs.py).
"""

from __future__ import annotations

import gc
import weakref
from collections import OrderedDict

import torch

from potato_tpu_torch.core import rng as prng
from potato_tpu_torch.core.types import RayBatch
from potato_tpu_torch.ops import flash, rng_kernel
from potato_tpu_torch.ops.material import pack_materials
from potato_tpu_torch.ops.texture import texture_counts
from potato_tpu_torch.render import integrator
from potato_tpu_torch.render.integrator import PathState, advance

MAX_VARIANTS = 8

_SCENES = {}      # id(accel.tri_flat) -> _SceneGraphs


def _leaves(state: PathState):
    return tuple(state.rays) + tuple(state[1:])


def _clone_state(state: PathState) -> PathState:
    return PathState(RayBatch(*(t.clone() for t in state.rays)),
                     *(t.clone() for t in state[1:]))


class _Variant:
    """One pass variant on `lanes` lanes: its input buffers, its bodies
    and, on a card, their two graphs."""

    def __init__(self, tables, accel, lanes, features, ior_score, aov_now,
                 device):
        self.refs = tuple(weakref.ref(t) for t in _tensors(tables, accel))
        self.features, self.ior_score, self.aov_now = \
            features, ior_score, aov_now
        self.packed = pack_materials(tables)
        f32 = dict(dtype=torch.float32, device=device)
        self.state = PathState(
            rays=RayBatch(torch.zeros((lanes, 3), **f32),
                          torch.zeros((lanes, 3), **f32),
                          torch.zeros((lanes,), **f32),
                          torch.zeros((lanes,), **f32)),
            radiance=torch.zeros((lanes, 3), **f32),
            throughput=torch.zeros((lanes, 3), **f32),
            active=torch.zeros((lanes,), dtype=torch.bool, device=device),
            aov_normal=torch.zeros((lanes, 3), **f32),
            aov_hit=torch.zeros((lanes,), dtype=torch.bool, device=device),
            segments=torch.zeros((), dtype=torch.int64, device=device))
        self.ray_ids = torch.zeros((lanes,), dtype=torch.int64,
                                   device=device)
        bp = -(-lanes // flash.R) * flash.R
        self.raw = (torch.zeros((bp,), **f32),
                    torch.zeros((bp,), dtype=torch.int32, device=device),
                    torch.zeros((bp,), **f32),
                    torch.zeros((bp,), dtype=torch.int32, device=device))
        self.graphs = None
        self.inputs = None     # graph A's outputs: FlashInputs
        self.out = None        # graph B's outputs: PathState
        self.draws = (0, 0, 0)  # rng_kernel.draw_counts a replay adds

    def valid_for(self, tables, accel) -> bool:
        tensors = _tensors(tables, accel)
        return len(tensors) == len(self.refs) and all(
            r() is t for r, t in zip(self.refs, tensors))

    def body_a(self, tables, accel):
        return flash.prepare_flash(accel, tables, self.state.rays)

    def body_b(self, tables, accel, words, bounce):
        hit = flash.flash_epilogue(accel, self.state.rays, self.raw,
                                   self.inputs.sph_dense)
        return advance(tables, self.packed, self.state, hit, words, bounce,
                       self.ray_ids, features=self.features,
                       ior_score=self.ior_score, aov_now=self.aov_now)

    def capture(self, tables, accel, words, bounce, pool):
        """Capture both graphs. A graph destroyed while another is being
        captured invalidates that capture, and the graphs of a scene that
        lies in a reference cycle go only when the cycle collector runs:
        so the collector runs now, and not during the captures. The draws
        and kernel launches the capture counted are made by each replay:
        they move from the counter to `draws`. The texture hits'
        accumulator is made before the capture, which would otherwise
        capture its zeroing."""
        a, b = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        drawn = rng_kernel.draw_counts.snapshot()
        texture_counts.hits_on(self.ray_ids.device)
        try:
            with torch.cuda.graph(a, pool=pool):
                self.inputs = self.body_a(tables, accel)
            with torch.cuda.graph(b, pool=pool):
                self.out = self.body_b(tables, accel, words, bounce)
        finally:
            if collecting:
                gc.enable()
            self.draws = tuple(now - was for now, was in
                               zip(rng_kernel.draw_counts.snapshot(), drawn))
            rng_kernel.draw_counts.add(*(-n for n in self.draws))
        self.graphs = (a, b)
        integrator.pass_counts.captures += 2

    def run(self, tables, accel, state, ray_ids, words, bounce) -> PathState:
        """One pass: the state into the buffers, graph A, the kernel on
        copies of its queues, graph B, a copy of the next state out."""
        for dst, src in zip(_leaves(self.state) + (self.ray_ids,),
                            _leaves(state) + (ray_ids,)):
            dst.copy_(src)
        flash.intersect_flash.lanes += self.ray_ids.shape[0]
        graphed = self.graphs is not None
        if graphed:
            self.graphs[0].replay()
        else:
            self.inputs = self.body_a(tables, accel)
        inp = self.inputs
        raw = flash.flash_hits(accel, inp._replace(
            packed_rays=inp.packed_rays.clone(),
            queues=flash.BlockQueues(*(q.clone() for q in inp.queues))))
        for dst, src in zip(self.raw, raw):
            dst.copy_(src)
        if graphed:
            self.graphs[1].replay()
            integrator.pass_counts.replayed += 1
            rng_kernel.draw_counts.add(*self.draws)
        else:
            self.out = self.body_b(tables, accel, words, bounce)
        return _clone_state(self.out)


def _tensors(tables, accel):
    return [t for t in tuple(tables) + tuple(accel)
            if isinstance(t, torch.Tensor)]


class _SceneGraphs:
    """The graphed pass variants of one scene, the memory pool they share
    and the device buffers they read: the seed's key words and the
    bounce."""

    def __init__(self, owner: torch.Tensor):
        dev = owner.device
        self.owner = weakref.ref(owner)
        self.pool = torch.cuda.graph_pool_handle() \
            if dev.type == "cuda" else None
        i64 = dict(dtype=torch.int64, device=dev)
        self.words = prng.Key(torch.zeros((), **i64),
                              torch.zeros((), **i64))
        self.bounce = torch.zeros((), **i64)
        self.filled = {}              # buffer name -> the value it holds
        self.seen = set()             # variant keys whose eager pass ran
        self.variants = OrderedDict()  # variant key -> _Variant, LRU last

    def fill(self, name, buffer, value: int):
        """Refill a device buffer where its value changes: a launch (the
        value is the fill's argument), no host-to-device copy."""
        if self.filled.get(name) != value:
            buffer.fill_(value)
            self.filled[name] = value

    def variant(self, tables, accel, lanes, features, ior_score, aov_now,
                capture: bool):
        """The variant's buffers and graphs; None on the variant's first
        sight where it captures (its pass then runs eagerly: that warms
        every kernel up before the capture)."""
        key = (id(tables), lanes, features, ior_score, aov_now)
        v = self.variants.get(key)
        if v is not None and v.valid_for(tables, accel):
            self.variants.move_to_end(key)
            return v
        self.variants.pop(key, None)
        if capture and key not in self.seen:
            if len(self.seen) >= 16 * MAX_VARIANTS:
                self.seen.clear()
            self.seen.add(key)
            return None
        v = _Variant(tables, accel, lanes, features, ior_score, aov_now,
                     accel.tri_flat.device)
        self.variants[key] = v
        while len(self.variants) > MAX_VARIANTS:
            self.variants.popitem(last=False)
        return v


def _scene_graphs(accel) -> _SceneGraphs:
    owner = accel.tri_flat
    key = id(owner)
    sg = _SCENES.get(key)
    if sg is None or sg.owner() is not owner:
        sg = _SCENES[key] = _SceneGraphs(owner)
        weakref.finalize(owner, _SCENES.pop, key, None)
    return sg


class GraphedStep:
    """`step(state, bounce, ray_ids)` of a flash scene, pass by pass
    through the graphed variants: on a card graph A, the kernel, graph B;
    on the CPU the same bodies eagerly. Returns None where the step has to
    run its eager pass instead (a variant's first pass on a card)."""

    def __init__(self, tables, accel, seed: int, features=None,
                 ior_score: bool = False, aovs: bool = True):
        self.tables, self.accel = tables, accel
        self.words = prng.key_from_seed(seed)
        self.features, self.ior_score, self.aovs = features, ior_score, aovs
        self.mine = {}       # (lanes, aov_now) -> this step's _Variant

    def __call__(self, state: PathState, bounce: int, ray_ids):
        lanes = ray_ids.shape[0]
        aov_now = self.aovs and bounce == 0
        sg = _scene_graphs(self.accel)
        v = self.mine.get((lanes, aov_now))
        if v is None:
            v = sg.variant(self.tables, self.accel, lanes, self.features,
                           self.ior_score, aov_now,
                           capture=sg.pool is not None)
            if v is None:
                return None
            self.mine[lanes, aov_now] = v
        sg.fill("k0", sg.words.k0, self.words.k0)
        sg.fill("k1", sg.words.k1, self.words.k1)
        sg.fill("bounce", sg.bounce, bounce)
        if sg.pool is not None and v.graphs is None:
            v.capture(self.tables, self.accel, sg.words, sg.bounce, sg.pool)
        return v.run(self.tables, self.accel, state, ray_ids, sg.words,
                     sg.bounce)
