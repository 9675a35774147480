"""Observable names (port of the naming part of qcdgpu_tpu/ops/measure.py).

Observable vector layout:
  plq      — mean plaquette (1/N) Re tr P, averaged over all 6 planes
  plq_s    — spatial planes only (xy, xz, yz)
  plq_t    — temporal planes only (xt, yt, zt)
  action   — Wilson action density S / (beta * 6 * V) = 1 - plq
  poly_re  — Re of the volume-averaged Polyakov loop (1/N normalized)
  poly_im  — Im of the same

The series row of obs_names() may end with one engine-accumulated column:
``acc_rate`` (track_acceptance) or ``kp_exhaust_rate`` (track_kp_exhaust).

The extended observables (Fmunu, Wilson loops, topological charge) are not
ported yet; configurations that ask for them are refused by
ops/cuda/engine.check_supported, so a measurement is the standard six.
"""

from __future__ import annotations

OBS_NAMES = ("plq", "plq_s", "plq_t", "action", "poly_re", "poly_im")
TIME_AXIS = 3  # mu index of the temporal direction


def measure_obs_names(cfg=None):
    """Names of the observables of one measurement."""
    return OBS_NAMES


def obs_names(cfg=None):
    """Column names of the per-measurement series row: the measurement
    plus the tracked statistic, where the reference puts it
    (ops/measure.py:385-394)."""
    names = measure_obs_names(cfg)
    if cfg is not None and getattr(cfg, "track_acceptance", False):
        names = names + ("acc_rate",)
    if cfg is not None and getattr(cfg, "track_kp_exhaust", False):
        names = names + ("kp_exhaust_rate",)
    return names
