"""epilogue.assembly_s in the cells whose time the host sets, where it moves
proof_s.host: the same reader (metrics/epilogue.assembly_s.py)."""

from harness.spec import reader

_base = reader("epilogue.assembly_s")
LAYER, UNIT, SOURCE = _base.LAYER, _base.UNIT, _base.SOURCE
MOVES = "proof_s.host"
read = _base.read
