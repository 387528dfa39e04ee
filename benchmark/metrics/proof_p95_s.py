"""95th percentile (nearest rank) of the latencies of all proofs of the
window: from handing the input to the entry to the proof (or the proof
file) back.  Below 20 proofs it is the slowest."""

import math

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    lat = sorted(p["latency_s"] for p in run["proofs"])
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
