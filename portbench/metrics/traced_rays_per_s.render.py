"""traced_rays_per_s.render: the rays the program says it traced
(`render.last_ray_count`, `render_sharded.last_ray_count`: closest-hit
and shadow rays, all ranks) over the wall time of the traced run's
window, whose images are not profiled."""

LAYER = "bounce loop and shading"
UNIT = "rays/s"
MOVES = "samples_per_s"
SOURCE = "program_counter"


def read(facts):
    rays, secs = facts.get("rays_traced"), facts.get("render_s")
    if not rays or not secs:
        return None
    return rays / secs
