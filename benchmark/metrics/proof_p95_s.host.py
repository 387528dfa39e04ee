"""proof_p95_s in the cells whose time the host sets (a file load a proof, or a
launch-bound small proof: the card idles a fifth to three quarters of
the window): the same reader (metrics/proof_p95_s.py) under a bound of its own.
Their run means spread four to ten times wider than a device-bound
cell's (PERF.md §2), so one bound for both would be theirs."""

from harness.spec import reader

_base = reader("proof_p95_s")
UNIT, BETTER, SOURCE = _base.UNIT, _base.BETTER, _base.SOURCE
read = _base.read
