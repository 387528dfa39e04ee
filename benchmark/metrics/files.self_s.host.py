"""Layer: CLI / files (models/gpu_prover.prove_files).  Host seconds a
proof in the root span "files.compute" (utils/profiling.py) less its
child spans (the file loads, the prover's blocks, the store): the command's
time that no layer's span names."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "CLI / files", "s", "proof_s.host", \
    "program_span"


def read(run):
    return mean_of(run, "laps", lambda k: k == "self:files.compute")
