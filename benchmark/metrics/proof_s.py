"""Seconds a proof: the window's host seconds (its start to the last
completion) over the proofs completed in it."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    n = len(run["proofs"])
    return run["window_s"] / n if n else None
