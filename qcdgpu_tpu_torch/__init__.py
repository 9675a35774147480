"""qcdgpu_tpu_torch — the PyTorch / CUDA port of qcdgpu_tpu for one NVIDIA
H100.

Pure-gauge SU(3) Wilson-action Monte Carlo: checkerboard Kennedy–Pendleton
heat-bath sweeps with Cabibbo–Marinari subgroups on the reference's packed
link layout, with reunitarization and the plaquette / action / Polyakov
measurements, unsharded or split over an X/Y mesh of halo-padded shards.
The hot path runs in hand-written CUDA kernels (csrc/), each beside its
plain PyTorch version, which the wrappers use for CPU tensors.  Imports
torch and numpy only — never jax or qcdgpu_tpu.
"""

from .config import SimConfig
from .sim import Simulation

__version__ = "0.1.0"

__all__ = ["SimConfig", "Simulation"]
