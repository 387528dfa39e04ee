"""Layer: device.  Share of the traced window in which no kernel, copy or
memset ran on the card (the profiler's timeline)."""

LAYER, UNIT, MOVES, SOURCE = "Device", "%", "proof_s", "device_trace"


def read(run):
    t = run.get("trace")
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
