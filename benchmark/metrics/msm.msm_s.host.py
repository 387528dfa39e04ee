"""msm.msm_s in the cells whose time the host sets, where it moves
proof_s.host: the same reader (metrics/msm.msm_s.py)."""

from harness.spec import reader

_base = reader("msm.msm_s")
LAYER, UNIT, SOURCE = _base.LAYER, _base.UNIT, _base.SOURCE
MOVES = "proof_s.host"
read = _base.read
