"""Layer: H pipeline (ops/ntt.py).  Seconds a proof in the block timer
"H pipeline (device NTT)"."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "H pipeline", "s", "proof_s", "program_span"


def read(run):
    return mean_of(run, "laps", lambda k: k.startswith("H pipeline"))
