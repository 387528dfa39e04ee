"""Layer: prover session (models/gpu_prover.py ProverSession).  Seconds a
proof in the block timers "stage params (host->device)" (a session made
for the proof: the files' compute) and "stage inputs (host->device)"."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "Prover session", "s", "proof_s", "program_span"


def read(run):
    return mean_of(run, "laps", lambda k: k.startswith("stage "))
