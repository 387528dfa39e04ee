"""Layer: CLI / files (utils/cli.py, models/gpu_prover.load_params,
load_input, load_preprocessed, utils/serialization.py).  Host seconds a
proof in the loaders, from the benchmark's spans around them."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "CLI / files", "s", "proof_s.host", "host_clock"


def read(run):
    return mean_of(run, "spans", lambda k: k.startswith("load "))
