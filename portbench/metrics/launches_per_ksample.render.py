"""launches_per_ksample.render: device operations (kernels, copies,
sets) in the traced image, on every rank, per thousand pixel samples of
that image."""

LAYER = "bounce loop and shading"
UNIT = "launches/ksample"
MOVES = "samples_per_s"
SOURCE = "device_trace"


def read(facts):
    dev, samples = facts.get("device"), facts.get("traced_samples")
    if not dev or not samples:
        return None
    return 1000.0 * dev.get("device_ops_all_ranks", dev["device_ops"]) / samples
