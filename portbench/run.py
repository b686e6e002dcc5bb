"""Run one cell of the benchmark of bfc_tpu_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cards the cell asks
for.  The last line of standard output is the result as one JSON object;
the last lines of standard error give each number the check compared,
beside its limit.  It exits non-zero, printing no result, without a CUDA
card (or with fewer than the cell needs), or where jax, jaxlib, flax or
bfc_tpu was loaded.  portbench/harness.py says what a run does.
"""

import os
import sys
import time

T0 = time.time()
HERE = os.path.dirname(os.path.abspath(__file__))
# import the benchmark as the package portbench from the checkout's root,
# never its files as top-level modules
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path.insert(0, os.path.dirname(HERE))

if __name__ == "__main__":
    from portbench import harness

    sys.exit(harness.main(t0=T0))
