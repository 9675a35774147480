"""The operations and bytes of one kernel call, and the H100's peaks.

A frozen copy of ``chip_smoke.py``'s ``work()`` / ``bound()`` and their
helpers (``chip_smoke.py:350-360`` for the peaks, ``:600-821`` for the
counts), kept here so that the benchmark's roofline arithmetic cannot move
with the program.  Changes from the original: the stream-generator branch
is left out (no cell draws from a PRNGCL stream), a stage's kind, group
and random source are passed as arguments instead of parsed from a kernel
name, and the chain axis of a beta scan multiplies a call's work.

Each input byte is counted read once and each output byte written once
(whatever a kernel reads again); a heat-bath's Kennedy-Pendleton trials
are counted in full.
"""

from __future__ import annotations

import itertools

from .reference import uniforms_per_subgroup

# One H100 SXM, NVIDIA's data sheet: HBM bandwidth and the f32 rate outside
# the tensor cores.  Integer operations run on their own pipe: 64 32-bit
# integer results per clock per SM (the CUDA C++ Programming Guide's
# throughput table, compute capability 9.0), times 132 SMs at the 1.98 GHz
# boost clock.  f64 outside the tensor cores: 33.5 TFLOP/s, an FMA counted
# as two.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
F64_OPS_PER_S = 33.5e12 / 2

# f32 operations per subgroup touch, counted from csrc/stage.cu: the
# heat-bath's set-up, one Kennedy-Pendleton trial and its direction +
# product; the overrelaxation flip; one Metropolis hit.
HB_SETUP, HB_TRIAL, HB_FINISH = 19, 97, 89
OR_FLIP = 42
METRO_HIT = 134
# Integer operations of one call of a counter-based source
# (csrc/common.cuh): threefry2x32-20, 2 key adds, 20 rounds of add, rotate
# and xor, 5 key injections of 3 adds, 2 xors for the parity key;
# Philox-4x32-10, 10 rounds of two wide multiplies and 4 xors, 9 key bumps
# of 2 adds.
THREEFRY_CALL_OPS = 20 * 3 + 2 + 5 * 3 + 2
PHILOX_CALL_OPS = 10 * (2 + 4) + 9 * 2


def mmul_ops(n):
    """f32 operations of one complex n x n product."""
    return n * n * (8 * n - 2)


def codec_ops(n):
    """SU(3) rebuilds row 2 on every load; SU(2) stores its whole matrix."""
    return 42 if n == 3 else 0


def rng_ops_per_site(n, kind, k_trials, n_hit, rng_mode):
    """Integer operations of a site's draws: one threefry call per slot,
    one Philox call per block of two slots; overrelaxation draws nothing."""
    per = uniforms_per_subgroup(kind, k_trials, n_hit)
    slots = (3 if n == 3 else 1) * ((per + 1) // 2)
    if rng_mode == "hw":
        return PHILOX_CALL_OPS * ((slots + 1) // 2)
    return THREEFRY_CALL_OPS * slots


def stage_ops_per_site(n, kind, k_trials, n_hit):
    """f32 operations of a site's stage."""
    staples = 13 * mmul_ops(n) + 5 * 2 * n * n + 19 * codec_ops(n)
    flip = {"heatbath": HB_SETUP + k_trials * HB_TRIAL + HB_FINISH,
            "overrelax": OR_FLIP, "metropolis": n_hit * METRO_HIT}[kind]
    n_sg = 3 if n == 3 else 1
    return staples + n_sg * (8 + 56 * n + flip)


def unit(axis):
    """(dx, dy) of one step along lattice axis 0..3."""
    return ((1, 0), (0, 1), (0, 0), (0, 0))[axis]


def stage_reads(mu, p):
    """The links one stage (mu, parity p) loads, as (array, dx, dy)."""
    reads = [(2 * mu + p, 0, 0)]
    m = unit(mu)
    for nu in range(4):
        if nu == mu:
            continue
        v = unit(nu)
        reads += [(2 * nu + p, 0, 0), (2 * mu + 1 - p, *v),
                  (2 * nu + 1 - p, *m),
                  (2 * nu + p, m[0] - v[0], m[1] - v[1]),
                  (2 * mu + 1 - p, -v[0], -v[1]),
                  (2 * nu + 1 - p, -v[0], -v[1])]
    return reads


def plane_reads():
    """The links the plane sums load over both parities."""
    reads = []
    for p in (0, 1):
        for mu, nu in itertools.combinations(range(4), 2):
            reads += [(2 * mu + p, 0, 0), (2 * nu + 1 - p, *unit(mu)),
                      (2 * nu + p, 0, 0), (2 * mu + 1 - p, *unit(nu))]
    return reads


def columns_read(reads, local):
    """Distinct (array, X/Y column) pairs that ``reads`` touch over every
    column of an unsharded lattice (axes wrap)."""
    lx, ly = local
    return len({(k, (x + dx) % lx, (y + dy) % ly) for k, dx, dy in reads
                for x in range(lx) for y in range(ly)})


def plane_decodes(dims):
    """Links a site of K3 loads and decodes (the tile kernel where Z*T/2 is
    a multiple of 128 and the T/2 slots tile 128)."""
    t2 = dims[3] // 2
    if 128 % t2 == 0 and dims[2] * t2 % 128 == 0:
        return 10 + 4 * t2 / 128
    return 16


def _volume(dims):
    v = 1
    for d in dims:
        v *= d
    return v


def stage_work(n, dims, kind, rng_mode="threefry", k_trials=4, n_hit=3,
               mu=1, parity=0, chains=1):
    """(bytes, f32, integer, f64 operations) of one stage call (K1, or K1c
    over ``chains`` chains)."""
    v2 = _volume(dims) // 2
    arr = 16 * n * v2
    col = arr // (dims[0] * dims[1])
    int_ops = 0 if kind == "overrelax" else rng_ops_per_site(
        n, kind, k_trials, n_hit, rng_mode)
    return (chains * (columns_read(stage_reads(mu, parity), dims[:2]) * col
                      + arr),
            chains * v2 * stage_ops_per_site(n, kind, k_trials, n_hit),
            chains * v2 * int_ops, 0)


def reunit_work(n, dims, chains=1):
    """One K2 call on one (direction, parity) array (K2c over chains)."""
    v2 = _volume(dims) // 2
    arr = 16 * n * v2
    return chains * 2 * arr, chains * v2 * (84 if n == 3 else 23), 0, 0


def measure_work(n, dims, chains=1):
    """One measurement: K3's plane sums and K4's Polyakov sums (K3c, K4c
    over chains), as two (bytes, f32, int, f64) tuples."""
    v2 = _volume(dims) // 2
    arr = 16 * n * v2
    col = arr // (dims[0] * dims[1])
    per_site = 6 * (2 * mmul_ops(n) + 4 * n * n) + plane_decodes(dims) * \
        codec_ops(n)
    plane = (chains * (columns_read(plane_reads(), dims[:2]) * col + 6 * 8),
             chains * 2 * v2 * per_site, 0, 0)
    x, y, z, t = dims
    per_col = (t - 1) * mmul_ops(n) + t * codec_ops(n) + 2 * (n - 1)
    poly = (chains * (2 * arr + 2 * 8), chains * x * y * z * per_col, 0, 0)
    return plane, poly


def bound(nbytes, f32_ops, int_ops, f64_ops=0):
    """The least ms of a call: its bytes at the HBM rate, or its f32, its
    integer and its f64 operations each at its own pipe's rate, whichever
    is longest; with what bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(f32_ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S,
                f64_ops / F64_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_ms(work):
    return bound(*work)[0]


# ---------------------------------------------------------------------------
# one sweep of a run configuration (SimConfig fields as a dict)
# ---------------------------------------------------------------------------


def sweep_stages_ms(cfg, chains=1):
    """The bound of one sweep's 8 (1 + n_or) stages, each at its (mu,
    parity)."""
    kinds = [cfg["algorithm"]] + ["overrelax"] * int(cfg["n_or"])
    return sum(bound_ms(stage_work(
        int(cfg["group"]), tuple(cfg["dims"]), kind, cfg["rng_mode"],
        int(cfg["kp_trials"]), int(cfg["n_hit"]), mu, parity, chains))
        for kind in kinds for parity in (0, 1) for mu in range(4))


def reunit_ms(cfg, chains=1):
    """The bound of one reunitarization: its 8 arrays."""
    return 8 * bound_ms(reunit_work(int(cfg["group"]), tuple(cfg["dims"]),
                                    chains))


def measure_ms(cfg, chains=1):
    """The bound of one measurement: plane sums and Polyakov sums."""
    return sum(bound_ms(w) for w in measure_work(
        int(cfg["group"]), tuple(cfg["dims"]), chains))
