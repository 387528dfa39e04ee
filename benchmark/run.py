"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.
The last line of standard output is the result (one JSON object); the
numbers compared against the reference follow on standard error, each
beside its limit.  Without a card it prints nothing on standard output
and exits with 3.  See benchmark/harness/cell.py.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))      # the port, from the checkout
sys.path.insert(0, HERE)

from harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
