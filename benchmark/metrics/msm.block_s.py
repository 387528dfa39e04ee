"""Layer: MSM (ops/msm.py).  Seconds a streamed MSM block, a proof: the
block timer "MSMs (device Pippenger)" (closed by a device sync, so wall
time) over the proof's counter "#msm.blocks" (utils/profiling.py),
averaged over the window's proofs.  A faster scan or a cheaper per-block
sort, carry chain, reduction or combine lowers it."""

LAYER, UNIT, MOVES, SOURCE = "MSM", "s", "proof_s", "program_span"
LAP, BLOCKS = "MSMs (device Pippenger)", "#msm.blocks"


def read(run):
    per = [p["laps"][LAP] / p["laps"][BLOCKS] for p in run["proofs"]
           if LAP in p.get("laps", {}) and p["laps"].get(BLOCKS)]
    return sum(per) / len(per) if per else None
