"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (transport_se_tpu_torch);
see benchmark/README.md.  The last line of standard output is the result
(JSON); standard error has the card, the set-up, the window, the trace and,
last, each number the check compared beside its limit.  Exit 3 without the
CUDA devices the cell needs, 4 if the run loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# the checkout's root, so that `benchmark` and the port import from it
sys.path[0] = str(Path(__file__).resolve().parent.parent)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
