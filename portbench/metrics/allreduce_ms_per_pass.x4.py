"""allreduce_ms_per_pass.x4: the device time of NCCL's kernels on rank 0
in the traced image, per pass of that image."""

LAYER = "parallel"
UNIT = "ms"
MOVES = "samples_per_s"
SOURCE = "device_trace"


def read(facts):
    dev, passes = facts.get("device"), facts.get("passes_traced")
    if not dev or not passes or not dev["nccl_device_s"]:
        return None
    return 1000.0 * dev["nccl_device_s"] / passes
