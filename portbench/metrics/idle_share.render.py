"""idle_share.render: 100 x (1 - the device's busy seconds in the
profiled image (the union of its device-activity intervals, averaged
over the ranks) / the median wall seconds of the window's images).

The profiler's record of each launch slows the host, which paces this
work, so the profiled image's own length would read the idle share high
(it runs a fifth longer on cbox.hd); the device's work does not change
under it, and the window's untraced images give the wall time."""

LAYER = "device"
UNIT = "%"
MOVES = "samples_per_s"
SOURCE = "device_trace"


def read(facts):
    dev, image_s = facts.get("device"), facts.get("image_s")
    if not dev or not image_s:
        return None
    return 100.0 * (1.0 - dev["busy_s"] / image_s)
