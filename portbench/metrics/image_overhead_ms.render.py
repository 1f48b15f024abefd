"""image_overhead_ms.render: the mean over the traced run's window (its
images are not profiled) of an image's wall time less the time of its
passes (the benchmark's spans around `render` and around each pass function
that `make_render_pass` returns; a pass waits for the device every few
bounces and before it leaves): the pass loop's own cost, set-up of the
passes and the film's develop and copy."""

LAYER = "pass loop"
UNIT = "ms"
MOVES = "samples_per_s"
SOURCE = "program_span"


def read(facts):
    v = facts.get("image_overhead_s")
    return None if v is None else 1000.0 * v
