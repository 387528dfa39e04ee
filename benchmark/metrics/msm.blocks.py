"""Layer: MSM (ops/msm.py).  Blocks a proof, from the program's counter
"#msm.blocks" (utils/profiling.py): one per msm_window_sums that
msm_window_sums_streamed runs (its span "msm.block"), a single pass
counting one.  MNT4753 2^24 takes 41 a proof: the G1 MSM's 2^26 rows in
32 blocks of 2^21 points, B2's in 9."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "MSM", "count", "proof_s", "program_span"


def read(run):
    return mean_of(run, "laps", lambda k: k == "#msm.blocks")
