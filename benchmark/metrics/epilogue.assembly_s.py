"""Layer: host epilogue (ops/msm.finalize_windows*, the C assembly).
Seconds a proof in the block timer "readback + host assembly"."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "Host epilogue", "s", "proof_s", "program_span"


def read(run):
    return mean_of(run, "laps", lambda k: k.startswith("readback"))
