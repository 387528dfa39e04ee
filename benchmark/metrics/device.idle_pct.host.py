"""device.idle_pct in the cells whose time the host sets, where it moves
proof_s.host: the same reader (metrics/device.idle_pct.py)."""

from harness.spec import reader

_base = reader("device.idle_pct")
LAYER, UNIT, SOURCE = _base.LAYER, _base.UNIT, _base.SOURCE
MOVES = "proof_s.host"
read = _base.read
