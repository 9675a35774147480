#!/usr/bin/env python3
"""ms/sweep of the PyTorch port's unsharded 32^4 paths on one card, to
compare two checkouts of the port within one chip call.

    python3 tools/port_sweep_ms.py [ROOT]

ROOT (default: this checkout) is the directory whose qcdgpu_tpu_torch is
timed; its kernels build into ROOT/build/ at first use.  To compare two
commits, unpack one into a gitignored directory (git archive) and run
parent, change, change, parent.

Each configuration (32^4, cold start, reunit_every=10, seed 0, threefry)
runs through Simulation(cfg) on the card: warmup(), then three times
thermalize(50) and run(50, 1), each timed on the host clock between
synchronisations.  The SU(2) stages are the shortest (about 0.1 ms), so
those rows show first when the host loop cannot keep the card busy.  One
line per configuration, with the card's nvidia-smi name and power limit.
"""

import subprocess
import sys
import time
from pathlib import Path

CONFIGS = (
    ("bench SU(3) heat-bath", dict(group=3, beta=6.0)),
    ("SU(3) Metropolis", dict(group=3, beta=6.0, algorithm="metropolis")),
    ("SU(2) heat-bath + 1 OR", dict(group=2, beta=2.4, n_or=1)),
    ("SU(2) Metropolis", dict(group=2, beta=2.4, algorithm="metropolis")),
)
SWEEPS = 50


def main():
    import torch

    if not torch.cuda.is_available():
        print("port_sweep_ms: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parents[1]).resolve()
    sys.path.insert(0, str(root))
    from qcdgpu_tpu_torch import SimConfig, Simulation

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    for label, kw in CONFIGS:
        sim = Simulation(SimConfig(dims=(32,) * 4, reunit_every=10,
                                   start="cold", seed=0, **kw))
        sim.warmup()
        unmeasured, measured = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            sim.thermalize(SWEEPS).sync()
            t1 = time.perf_counter()
            sim.run(SWEEPS, 1)
            sim.sync()
            t2 = time.perf_counter()
            unmeasured.append((t1 - t0) / SWEEPS * 1e3)
            measured.append((t2 - t1) / SWEEPS * 1e3)
        print(f"{root}: {label}: ms/sweep unmeasured "
              + " ".join(f"{x:.3f}" for x in unmeasured)
              + "; measured every sweep "
              + " ".join(f"{x:.3f}" for x in measured) + f"  [{smi}]",
              flush=True)
        del sim
    return 0


if __name__ == "__main__":
    sys.exit(main())
