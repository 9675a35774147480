"""The model families and the beta-scan ensemble (port of
qcdgpu_tpu/models)."""

from .ensemble import BetaScan, make_ensemble_runner
from .gauge import SU2PureGauge, SU3PureGauge, baseline_config

__all__ = ["BetaScan", "SU2PureGauge", "SU3PureGauge", "baseline_config",
           "make_ensemble_runner"]
