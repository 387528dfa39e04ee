"""Layer: MSM (ops/msm.py).  Host waits on the device a proof, from the
program's counter "#msm.host_syncs" (utils/profiling.py): one per step of
a window block's carry chain (`prop.any()` read on the host) and one per
wait on a streamed block's upload event.  At each the card drains."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "MSM", "count", "proof_s", "program_span"


def read(run):
    return mean_of(run, "laps", lambda k: k == "#msm.host_syncs")
