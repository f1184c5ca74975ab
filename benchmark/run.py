"""One run of one benchmark cell.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints earlier lines (set-up, outcome, the compared numbers) and, as the
last line of standard output, the result object; the compared numbers
and their limits are also the last lines of standard error. Exits with 2
and no result without a card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded.
"""

import os
import sys
import time

T0 = time.perf_counter()
# one process with few threads: no library spins up a pool of its own
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
