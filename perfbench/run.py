"""Run one cell of the port's benchmark and print its result line:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (`python3 -m perfbench.run ...` too). See
`perfbench/harness.py` for what a run does and `PERF.md` for the cells.
"""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from perfbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
