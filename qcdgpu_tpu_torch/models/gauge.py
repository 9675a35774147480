"""The model families: pure-gauge SU(2) and SU(3) Wilson-action theories
— port of qcdgpu_tpu/models/gauge.py.

Each is a thin preset over the shared Simulation, plus the BASELINE.md
acceptance configurations.
"""

from __future__ import annotations

from ..config import SimConfig
from ..sim import Simulation


class SU2PureGauge(Simulation):
    """Pure SU(2) gluodynamics, Wilson one-plaquette action."""

    def __init__(self, cfg: SimConfig = None, *, device="cuda", **kw):
        if cfg is None:
            cfg = SimConfig(group=2, dims=(8, 8, 8, 8), beta=2.4, **kw)
        elif cfg.group != 2:
            raise ValueError("SU2PureGauge requires group=2")
        super().__init__(cfg, device=device)


class SU3PureGauge(Simulation):
    """Pure SU(3) gluodynamics, Wilson one-plaquette action."""

    def __init__(self, cfg: SimConfig = None, *, device="cuda", **kw):
        if cfg is None:
            cfg = SimConfig(group=3, dims=(16, 16, 16, 16), beta=6.0, **kw)
        elif cfg.group != 3:
            raise ValueError("SU3PureGauge requires group=3")
        super().__init__(cfg, device=device)


def baseline_config(n: int) -> SimConfig:
    """The acceptance configurations of BASELINE.md / BASELINE.json (4 is
    the RNG parity suite, which has no SimConfig)."""
    if n == 1:  # SU(2) heat-bath, 8^4, beta=2.4
        return SimConfig(group=2, dims=(8, 8, 8, 8), beta=2.4,
                         algorithm="heatbath", sweeps_therm=200, sweeps=500)
    if n == 2:  # SU(3) HB+OR, 16^4, beta=6.0
        return SimConfig(group=3, dims=(16, 16, 16, 16), beta=6.0,
                         algorithm="heatbath", n_or=1,
                         sweeps_therm=300, sweeps=500)
    if n == 3:  # finite-T scan lattice 24^3 x 6 (beta set per scan point)
        return SimConfig(group=3, dims=(24, 24, 24, 6), beta=5.89,
                         algorithm="heatbath", n_or=2,
                         sweeps_therm=200, sweeps=400)
    if n == 5:  # SU(3) 32^4 over 8 devices
        from ..parallel.mesh import default_mesh_shape

        dims = (32, 32, 32, 32)
        # the shared X/Y-major mesh policy, as the reference routes it
        return SimConfig(group=3, dims=dims, beta=6.0,
                         algorithm="heatbath", n_or=1,
                         mesh=default_mesh_shape(8, dims),
                         sweeps_therm=100, sweeps=200)
    raise ValueError(f"no baseline config #{n} (4 is the RNG parity suite)")
