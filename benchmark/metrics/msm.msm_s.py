"""Layer: MSM (ops/msm.py, ops/straus.py).  Seconds a proof in the block
timer whose label starts with "MSMs" (Pippenger, or Straus tables and
Pippenger A/H)."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "MSM", "s", "proof_s", "program_span"


def read(run):
    return mean_of(run, "laps", lambda k: k.startswith("MSMs"))
