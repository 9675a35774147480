"""Run one cell of the benchmark of qcdgpu_tpu_torch on this machine's
cards and print its result line (see harness.py):

    python3 portbench/run.py --workload su3_32.hb_hw --seed 7 \
        --seconds 10 --trace 0
"""

import time

T0 = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t0=T0))
