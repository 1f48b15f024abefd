"""isect_roofline.render: the least time of the traced image's ray
queries (lib/roofline.py: rays and answers once, the triangles once a
call, at the card's bandwidth) over the device time of what they
launched (rank 0)."""

from portbench.lib import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "samples_per_s"
SOURCE = "device_trace"


def read(facts):
    return roofline.traced_share(facts)
