"""Layer: H pipeline (ops/ntt.py).  Host seconds a proof in the program's
span "ntt.addsub" (utils/profiling.py), summed over every NTT level: the
level's E + t and E - t through add_words / sub_words.  The cells listed
are those whose H lap the host bounds (MNT6753 2^15); at 2^20 the span
would time the enqueue, not the work."""

from harness.records import mean_of

LAYER, UNIT, MOVES, SOURCE = "H pipeline", "s", "proof_s.host", \
    "program_span"


def read(run):
    return mean_of(run, "laps", lambda k: k == "ntt.addsub")
