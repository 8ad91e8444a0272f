"""Share of the texture samplers' work that shading used: 100 x the
window's hits / its lanes, summed over the Perlin, value-noise and image
samplers. The hits are the port's program counter
`ops/texture.py::texture_counts`: the lanes whose material (or background)
read that kind, an int64 accumulator on the device, added to inside the
pass, taken right before and right after the window as device copies (no
sync) and read here. The lanes: shading computes every texture kind a scene
has on every lane it shades and selects by kind, once a lane that the bounce
passes handed to the intersector (`ops/flash.py::intersect_flash.lanes`,
read from tensor shapes on the host), so each counted sampler that ran
(`texture_counts.kinds_run`) ran on those lanes. (A textured sky sphere
would sample its background a second time a lane; no cell has one.) None
where the program has no such counter or no counted sampler ran in the
window.

So a sampler that one material in a hundred reads still runs on every lane:
the share is the part of that work that counts."""


def _snapshot():
    try:
        from potato_tpu_torch.ops import flash, texture
    except ImportError:
        return None
    counts = getattr(texture, "texture_counts", None)
    lanes = getattr(flash.intersect_flash, "lanes", None)
    if counts is None or lanes is None:
        return None
    return lanes, len(counts.kinds_run), counts.hits_clone()


def before_window(run):
    run.state["texture_before"] = _snapshot()


def after_window(run):
    run.state["texture_after"] = _snapshot()


def read(run):
    before = run.state.get("texture_before")
    after = run.state.get("texture_after")
    if before is None or after is None or after[0] <= before[0] \
            or not after[1]:
        return None
    from potato_tpu_torch.ops.texture import COUNTED

    hits = 0
    for dev, acc in after[2].items():
        was = before[2].get(dev)
        hits += int((acc if was is None else acc - was)[list(COUNTED)].sum())
    return 100.0 * hits / ((after[0] - before[0]) * after[1])
