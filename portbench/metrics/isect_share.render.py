"""isect_share.render: the device time of the operations launched inside
the ray queries (`intersect`, `occluded`, wrapped in spans wherever the
program holds them) over all device time of the traced image (rank 0)."""

LAYER = "intersection"
UNIT = "%"
MOVES = "samples_per_s"
SOURCE = "device_trace"


def read(facts):
    dev = facts.get("device")
    if not dev or not dev["device_s"] or not dev["isect_device_s"]:
        return None
    return 100.0 * dev["isect_device_s"] / dev["device_s"]
