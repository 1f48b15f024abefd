"""What the render cells' per-layer readers read, from the spans and
counters of a traced run."""

import statistics


def render_facts(ctx, rays, samples, traced, triangles):
    """What the render cells' per-layer readers read (empty untraced).
    The last image is the profiled one, rendered once the window has
    closed: the device readers read it, while the rays a second, the pass
    loop's overhead and an image's wall time are read from the window's
    images before it, which run as in an untraced run."""
    if not ctx.trace:
        return {}
    renders, passes = ctx.spans.records["render"], ctx.spans.records["pass"]
    traced_span, rest = renders[-1], renders[:-1]
    facts = {
        "traced_samples": samples,
        "triangles": triangles,
        "queries": traced.get("queries", {}),
        "passes_traced": sum(1 for s, e in passes
                             if traced_span[0] <= s and e <= traced_span[1]),
    }
    if rest:
        overhead = [(b - a) - sum(e - s for s, e in passes if a <= s and e <= b)
                    for a, b in rest]
        facts.update(image_overhead_s=sum(overhead) / len(overhead),
                     rays_traced=sum(rays[:-1]), render_s=sum(b - a for a, b in rest),
                     image_s=statistics.median(b - a for a, b in rest))
    return facts
