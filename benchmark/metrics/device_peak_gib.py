"""torch.cuda.max_memory_allocated over the window (reset after set-up),
in GiB."""

UNIT, BETTER, SOURCE = "GiB", "lower", "device_trace"


def read(run):
    b = run.get("device_peak_bytes")
    return b / 2 ** 30 if b else None
