"""Run one cell of the port's benchmark once.

    python3 h9bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout on a machine with the card(s) the cell asks
for.  Prints one JSON line last on standard output (``harness.main``).
Only the standard library is imported here, so the reference's worker
processes, which import this file as their main module, start light.
"""

import time

_T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    from h9bench.harness import main as run
    return run(sys.argv[1:], _T0)


if __name__ == "__main__":
    sys.exit(main())
