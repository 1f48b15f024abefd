"""pack_s: seconds of the benchmark's span around loading the scene and
packing it (scene/xml_loader.py, scene/builder.py, accel/bvh.py,
accel/clusters.py), synchronised, in set-up."""

LAYER = "scene load and pack"
UNIT = "s"
MOVES = "setup_s"
SOURCE = "program_span"


def read(facts):
    return facts.get("pack_s")
