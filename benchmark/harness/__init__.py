"""The benchmark's harness: the cell runner (cell.py), the entries a mix
drives (entries.py), the trace recorders and reader (trace.py), the
kernels' bound (roofline.py), the helpers of the metric readers
(records.py) and the lookup of its data files (spec.py)."""
