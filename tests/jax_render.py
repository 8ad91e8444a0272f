"""The JAX package's losses and sharded functions, their render compiled
for the scene's features.

They leave `features` unset, so `render_chunk` computes every material,
texture and lens variant for every lane: the same values, since a variant
the scene lacks is one no lane selects, but a graph that takes minutes to
compile on the CPU, for the loss and again for its gradient.
"""

from contextlib import contextmanager
from functools import partial

import pytest

import potato_tpu.diff.optimize as joptimize
from potato_tpu.render import renderer as jrenderer


@contextmanager
def specialized_render(jscene, module=joptimize):
    """While open, `module`'s functions build their render for
    `jscene.features`: by default make_render_loss and optimize_textures;
    `potato_tpu.parallel.shard` for the sharded render and train step."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "render_chunk",
                   partial(jrenderer.render_chunk, features=jscene.features))
        yield
