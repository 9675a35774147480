"""Frozen run configuration — a field-for-field mirror of qcdgpu_tpu.config.

Same field names, defaults, validation, ``replace``, ``to_dict`` and
``from_dict``, so a configuration dict written by the JAX package loads here
unchanged.  Validation mirrors the reference's ValueErrors exactly;
``resolve_engine`` picks the engine a configuration runs on.

The PRNGCL generator names are constants here (the reference imports them
from ops/prng_streams.py, which needs jax).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

STREAM_GENERATORS = (
    "ranlux0", "ranlux1", "ranlux2", "ranlux3", "ranlux4",
    "ranmar", "xor128", "xor7", "mrg32k3a", "parkmiller", "constant",
)
REF_STREAM_GENERATORS = (
    "ranlux0", "ranlux1", "ranlux2", "ranlux3", "ranlux4", "ranmar",
)
PALLAS_STREAM_GENERATORS = (
    "xor128", "xor7", "mrg32k3a", "parkmiller", "constant",
) + REF_STREAM_GENERATORS


def stream_mode_name(rng_mode: str):
    """The generator name if rng_mode selects a PRNGCL stream, else None."""
    if rng_mode.startswith("prngcl:"):
        return rng_mode.split(":", 1)[1]
    return None


@dataclass(frozen=True)
class SimConfig:
    # --- physics ---------------------------------------------------------
    group: int = 3  # N of SU(N); 2 or 3
    dims: Tuple[int, int, int, int] = (8, 8, 8, 8)  # (X, Y, Z, T)
    beta: float = 6.0

    # --- algorithm -------------------------------------------------------
    algorithm: str = "heatbath"  # "heatbath" | "metropolis"
    n_or: int = 0  # overrelaxation sweeps appended to each update sweep
    kp_trials: int = 4  # fixed Kennedy-Pendleton trial count
    n_hit: int = 3  # Metropolis hits per subgroup touch
    metro_delta: float = 0.35  # Metropolis proposal spread

    # --- run schedule ----------------------------------------------------
    start: str = "cold"  # "cold" | "hot" | "continue"
    sweeps_therm: int = 100
    sweeps: int = 400
    meas_every: int = 1
    reunit_every: int = 10  # reunitarize every k-th sweep (0 = never)
    ckpt_every: int = 0

    # --- extended measurements ------------------------------------------
    get_fmunu: bool = False
    fmunu_index1: int = 0
    fmunu_index2: int = 0
    track_acceptance: bool = False
    track_kp_exhaust: bool = False
    wilson_loops: Tuple[Tuple[int, int], ...] = ()
    get_qtop: bool = False
    qtop_smear: int = 0
    qtop_alpha: float = 0.5

    # --- numerics --------------------------------------------------------
    seed: int = 0
    dtype: str = "complex64"  # "complex64" | "complex128"
    meas_dtype: str = "same"  # "same" | "double"

    # --- engine ----------------------------------------------------------
    # "pallas" selects the packed engine's hand-written GPU kernels (on a
    # CUDA device) or their plain PyTorch versions (on the CPU); "xla" the
    # dense engine (dense.py, on any 4D mesh); "auto" the packed one for
    # complex64 and the dense one for complex128 or a Z/T mesh
    # (resolve_engine).
    engine: str = "auto"  # "auto" | "xla" | "pallas"
    rng_mode: str = "threefry"  # "threefry" | "hw" | "prngcl:<gen>"

    # --- parallel --------------------------------------------------------
    mesh: Tuple[int, int, int, int] = (1, 1, 1, 1)
    # Accepted for config compatibility and ignored: the GPU kernels never
    # tile Y.
    y_block: int = 0

    def __post_init__(self):
        if self.group not in (2, 3):
            raise ValueError("group must be 2 or 3")
        if len(self.dims) != 4:
            raise ValueError("dims must be a 4-tuple (X, Y, Z, T)")
        if len(self.mesh) != 4:
            raise ValueError("mesh must be a 4-tuple over (X, Y, Z, T)")
        if self.algorithm not in ("heatbath", "metropolis"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.start not in ("cold", "hot", "continue"):
            raise ValueError(f"unknown start {self.start!r}")
        if self.engine not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown engine {self.engine!r}")
        gen = stream_mode_name(self.rng_mode)
        if gen is not None:
            if gen not in STREAM_GENERATORS:
                raise ValueError(
                    f"unknown PRNGCL generator {gen!r}; "
                    f"have {STREAM_GENERATORS}"
                )
            if self.engine == "pallas" and gen not in PALLAS_STREAM_GENERATORS:
                raise ValueError(
                    f"generator {gen!r} has no in-kernel form — use "
                    "engine='xla'/'auto', or one of "
                    f"{PALLAS_STREAM_GENERATORS} on the Pallas engine"
                )
        elif self.rng_mode not in ("threefry", "hw"):
            raise ValueError(f"unknown rng_mode {self.rng_mode!r}")
        if self.engine == "pallas" and (self.mesh[2] != 1 or self.mesh[3] != 1):
            raise ValueError(
                "the sharded Pallas engine decomposes along X/Y only; "
                "Z/T meshes run on the XLA engine (engine='auto' picks it)"
            )
        if self.meas_dtype not in ("same", "double"):
            raise ValueError(f"unknown meas_dtype {self.meas_dtype!r}")
        if self.ckpt_every < 0:
            raise ValueError("ckpt_every must be >= 0")
        if self.y_block < 0:
            raise ValueError("y_block must be >= 0")
        if 0 < self.y_block < self.dims[1] and self.dims[1] % self.y_block:
            raise ValueError(
                f"y_block={self.y_block} must divide Y={self.dims[1]}"
            )
        if self.ckpt_every and self.meas_every and (
            self.ckpt_every % self.meas_every
        ):
            raise ValueError(
                "ckpt_every must be a multiple of meas_every so the "
                "measurement series is independent of checkpoint chunking"
            )
        nm1 = self.group * self.group - 1
        for a in (self.fmunu_index1, self.fmunu_index2):
            if not 0 <= a <= nm1:
                raise ValueError(
                    f"fmunu index {a} out of range 0..{nm1} for SU({self.group})"
                )
        for p in self.wilson_loops:
            if len(p) != 2:
                raise ValueError(f"wilson_loops entries are (R, T) pairs, got {p}")
            r, t = p
            if not (1 <= r < min(self.dims[:3])):
                raise ValueError(
                    f"wilson loop R={r} must be in 1..{min(self.dims[:3]) - 1} "
                    "(spatial extents; loops wrapping the torus are Polyakov-"
                    "type correlators, not Wilson loops)"
                )
            if not (1 <= t < self.dims[3]):
                raise ValueError(
                    f"wilson loop T={t} must be in 1..{self.dims[3] - 1}"
                )
        if self.qtop_smear < 0:
            raise ValueError("qtop_smear must be >= 0")
        if not 0.0 < self.qtop_alpha <= 1.0:
            raise ValueError("qtop_alpha must be in (0, 1]")
        if self.track_acceptance and self.algorithm != "metropolis":
            raise ValueError("track_acceptance requires algorithm='metropolis'")
        if self.track_kp_exhaust and self.algorithm != "heatbath":
            raise ValueError("track_kp_exhaust requires algorithm='heatbath'")
        if self.engine == "xla" and self.rng_mode == "hw":
            raise ValueError(
                "rng_mode='hw' (TPU hardware PRNG) is a Pallas-engine "
                "feature; the XLA engine always draws threefry streams"
            )
        if self.engine == "pallas" and self.dtype != "complex64":
            raise ValueError("the pallas engine is float32 (complex64) only")
        if not 0 <= self.n_or <= 7:
            raise ValueError("n_or must be in 0..7")
        for d, m in zip(self.dims, self.mesh):
            if d % (2 * m) != 0:
                raise ValueError(
                    f"each dim must be even per mesh shard (dims={self.dims}, "
                    f"mesh={self.mesh}) so the checkerboard tiles cleanly"
                )

    # -- helpers ----------------------------------------------------------
    @property
    def volume(self) -> int:
        v = 1
        for d in self.dims:
            v *= d
        return v

    @property
    def n_links(self) -> int:
        return 4 * self.volume

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "SimConfig":
        d = dict(d)
        d["dims"] = tuple(d["dims"])
        d["mesh"] = tuple(d.get("mesh", (1, 1, 1, 1)))
        d["wilson_loops"] = tuple(
            tuple(p) for p in d.get("wilson_loops", ())
        )
        return cls(**d)


def resolve_engine(cfg: SimConfig) -> str:
    """The engine a configuration runs on: "xla" (the dense engine,
    dense.py, on one device or any 4D mesh) or "pallas" (the packed
    engine's hand-written CUDA kernels, ops/cuda/, on one device or an X/Y
    mesh).

    The reference's rules (qcdgpu_tpu/sim.py:235-284) with the H100 in the
    TPU's place: an explicit cfg.engine is kept; "auto" gives the dense
    engine for complex128 (the packed engine is f32) and for a mesh that
    splits Z or T; complex64 stays on the packed engine whatever
    meas_dtype says (its K3/K4 sum in f64)."""
    if cfg.engine != "auto":
        return cfg.engine
    if cfg.dtype != "complex64":
        return "xla"
    if cfg.mesh[2] != 1 or cfg.mesh[3] != 1:
        return "xla"
    return "pallas"
