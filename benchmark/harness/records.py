"""Helpers of the metric readers (benchmark/metrics/*.py) over a run
record: {"setup_s", "window_s", "device_peak_bytes", "proofs": [{"input",
"latency_s", "bytes", "error", "laps", "spans"}], "trace": None or
{"window_s", "busy_s", "kernel_s", "breakdown", "launches", "peaks"}}."""


def mean_of(run, key, pick):
    """Mean over the window's proofs of the sum of the entries of
    proof[key] (the port's block laps, or the benchmark's spans) whose
    label pick(label) accepts; None if no proof has one."""
    vals = []
    for p in run["proofs"]:
        hit = [v for k, v in p.get(key, {}).items() if pick(k)]
        if hit:
            vals.append(sum(hit))
    return sum(vals) / len(vals) if vals else None
