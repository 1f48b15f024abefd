"""The least time a ray query needs, whatever implements it.

A query reads each ray's origin, direction and t range once, writes each
answer once, and reads the scene's triangle records once a call.  Its
least time is those bytes over the card's memory bandwidth.  No count of
tests enters: the tests a query needs depend on the design, and such a
count goes stale when the design changes.  So the share reads the same
work whatever implements the queries, and cannot pass 100 %.
"""

from __future__ import annotations

RAY_BYTES = 3 * 4 + 3 * 4 + 2 * 4  # origin, direction, t range (float32)
CLOSEST_HIT_BYTES = 4 + 4 + 2 * 4  # t, triangle id, barycentrics
ANY_HIT_BYTES = 1  # a boolean
TRIANGLE_BYTES = 3 * 3 * 4  # three float32 corners

# published memory bandwidth (bytes/s) of the card measured, NVIDIA's data sheet
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}  # SXM5


def query_bytes(closest_rays, any_rays, calls, triangles):
    """Bytes that `calls` queries of closest_rays + any_rays rays over
    `triangles` triangles move at the least."""
    return ((closest_rays + any_rays) * RAY_BYTES + closest_rays * CLOSEST_HIT_BYTES
            + any_rays * ANY_HIT_BYTES + calls * triangles * TRIANGLE_BYTES)


def share_percent(nbytes, device_s, card):
    """The roofline share in %, or None where no device time was read.
    A card whose bandwidth the table lacks raises KeyError."""
    if not device_s or device_s <= 0:
        return None
    return 100.0 * nbytes / PEAK_BYTES_PER_S[card] / device_s


def traced_share(facts):
    """The share in % of the traced queries' least time in the device time
    of what they launched (the facts of a traced run), or None where the
    run traced no query."""
    dev, q = facts.get("device"), facts.get("queries")
    if not dev or not q:
        return None
    nbytes = query_bytes(q.get("closest_rays", 0), q.get("any_rays", 0),
                         q.get("closest_calls", 0) + q.get("any_calls", 0), facts["triangles"])
    return share_percent(nbytes, dev["isect_device_s"], facts.get("card"))
