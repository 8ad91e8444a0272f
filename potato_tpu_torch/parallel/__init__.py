"""Scale-out: the ray axis split over processes with torch.distributed.

Counterpart of potato_tpu/parallel/: the flat (pixel x sample) ray axis is
the data-parallel axis, the scene tables are replicated on every rank, and
the only communication is the sum of segments and the gather of the image
(render), or the sum of the scene-parameter gradient and the loss
(training). `launch.spawn` runs a function on local processes;
`launch.dryrun_multichip` drives both paths.
"""

from potato_tpu_torch.parallel.mesh import RayGroup, make_ray_group  # noqa: F401
from potato_tpu_torch.parallel.shard import (  # noqa: F401
    make_sharded_render_fn,
    make_sharded_train_step,
)
