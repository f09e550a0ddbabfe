"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the ``cpu_based_ray_tracer_tpu_torch``
package.  Needs as many CUDA cards as the cell asks for; without them it
exits non-zero and prints no result.  See ``portbench/harness.py``."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this script's folder
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
