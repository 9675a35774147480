"""Observable names (port of the naming part of qcdgpu_tpu/ops/measure.py).

Observable vector layout:
  plq      — mean plaquette (1/N) Re tr P, averaged over all 6 planes
  plq_s    — spatial planes only (xy, xz, yz)
  plq_t    — temporal planes only (xt, yt, zt)
  action   — Wilson action density S / (beta * 6 * V) = 1 - plq
  poly_re  — Re of the volume-averaged Polyakov loop (1/N normalized)
  poly_im  — Im of the same

The extended observables (Fmunu, Wilson loops, topological charge) and the
tracked-rate columns are not ported yet; configurations that ask for them
are refused by ops/cuda/engine.check_supported, so the names here are the
standard six.
"""

from __future__ import annotations

OBS_NAMES = ("plq", "plq_s", "plq_t", "action", "poly_re", "poly_im")
TIME_AXIS = 3  # mu index of the temporal direction


def measure_obs_names(cfg=None):
    """Names of the observables of one measurement."""
    return OBS_NAMES


def obs_names(cfg=None):
    """Column names of the per-measurement series row."""
    return measure_obs_names(cfg)
