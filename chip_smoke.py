#!/usr/bin/env python3
"""Build the port's CUDA kernels and run its main paths on one GPU.

    python3 chip_smoke.py                    # one card
    python3 chip_smoke.py --cards 4          # the sharded path across 4 cards

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and nvcc.  With ``--cards N`` it builds the kernels and runs only phase 7:
the bench configuration on an XY mesh, SU(3) heat-bath + 1 OR with
track_kp_exhaust on an X mesh, and on an XY mesh prngcl:ranlux3, ranmar
with 8 KP trials and SU(2) Metropolis with 25 hits on ranlux3 (stages past
48 KB of shared memory), each with its shards spread over N cards, against the unsharded chain on card 0
(links, series and streams bit-identical); then a scan of 2N chains on
(2,2,1,1) with its N chain blocks on the N cards against one block on
card 0 (links and series bit-identical), one measured block of
phase 8's main path (c) on the XY mesh across the cards against card 0,
and the dense engine's complex128 SU(3) 32^4 run on (1,1,2,2) with its
shards on the cards against card 0's unsharded dense run (links
bit-identical).
With no argument, phases 1-6, 8 and 9, each timed:

  1. device     — card name and power limit, torch / CUDA / nvcc versions;
  2. build      — nvcc builds csrc/*.cu into build/ (one process per
                  source, all at once); registers, stack frame and spills
                  of every kernel instantiation, threefry, Philox and
                  stream, unsharded, on a shard (K1a, K5a, K5b: "_shard"),
                  over a chain axis (K1c: "_chains") and both (K1ac:
                  "_shard_chains"; K5a/K5b and K5ac/K5bc share their
                  kernels, as K3/K4 and K3c/K4c do), every K1, K3 and
                  K4 instantiation with no stack frame and no spills
                  (the stream ones included); the static SASS
                  instruction mix of K1 Philox SU(3) heat-bath, K3 SU(3)
                  and K1 SU(3) heat-bath of every stream family, beside
                  the constant stream's, where the toolkit has cuobjdump;
  3. kernels    — every kernel instantiation against its plain PyTorch
                  version on the card (hot starts, seed 1): K1 threefry for
                  each kind x group x tracking, every (mu, parity), at
                  (4,4,2,4) and 32^4 (above (4,4,2,4) the K1, K1a, K1c
                  and K1ac comparisons take four of a sweep's stages,
                  each parity and direction once, the two halves in turn
                  by a family's calls at a shape, so that together they
                  take all 8 (checked): sweep_stages),
                  tracked counts included; K1 streams
                  for all 11 PRNGCL generators x heat-bath/Metropolis x
                  group x tracking at (4,4,2,4), every (mu, parity) in
                  sweep order on carried streams (words bit-identical),
                  every stream instantiation again at 8^4 with the
                  generator of its own phase-5 run, and ranlux3, ranmar,
                  xor128, mrg32k3a at 32^4 (SU(3) heat-bath and tracked
                  Metropolis); K8's index schedule: one heat-bath stage
                  at (4,4,2,4) for every ranlux pointer 0..23 x luxury
                  counter in {0, 1, 23, 24} x level 0-4 (SU(3), SU(2))
                  and every ranmar pointer 0..96 (SU(3)), unsharded and
                  on shard 0 of (2,2,1,1), and a few with 8 KP trials
                  or 25 Metropolis hits (longer subgroups, past 48 KB of
                  shared memory) and ranlux0-4 subgroups past a column's
                  413 draws (SU(3) Metropolis with 110 hits, SU(2)
                  heat-bath with 210 KP trials), words bit-identical to
                  prng_streams.draw_words, the 48 KB ones against the
                  stage twin (links and counts) and the long ranlux ones
                  through Simulation at 8^4 (a few sites' words against
                  draw_words); K1 Philox (rng_mode "hw",
                  K9's port) for each drawing kind x group x tracking
                  at (4,4,2,4) and at its own phase-5 run's 8^4 shape,
                  SU(3) heat-bath (and
                  tracked) at 32^4, all bit-identical with equal counts;
                  K2-K4 for SU(3) and SU(2) at
                  (4,4,2,4), (8,8,8,6) (T/2 odd) and 32^4; K4 again at
                  8^4, 16^4, (2,2,2,72) (T/2 = 36: two slot pairs a
                  lane) and SU(3) 64^4, and K5b on the shards of 64^4 on
                  (1,8,1,1), the T/2 of every phase-5 path; every K1a
                  instantiation (threefry and stream) on the shards of
                  (8,8,4,4) mesh (2,2,1,1) and again at the 8^4 shape,
                  X, Y or XY mesh and generator of its own phase-5 run,
                  SU(3) heat-bath (and tracked) at 32^4 on (2,2,1,1),
                  Philox SU(3) heat-bath (and tracked) at 32^4 on
                  (2,2,1,1) too, every (mu, parity) in sweep order with
                  the halo refresh between stages, streams on carried
                  words; K5a/K5b per shard at (8,8,4,4) and 32^4 on the
                  XY, X and Y meshes; every K1c instantiation (threefry
                  and Philox) over the 8 stages of a sweep at (4,4,2,4)
                  with 3 chains of distinct beta, and SU(3) HB, OR and
                  tracked HB at 24^3 x 6 with the 11 chains of the scan's
                  beta grid 5.6:6.1:11, each against its plain twin and
                  against K1 on every chain's arrays (|d| 0, per-chain
                  counts equal); K2c, K3c, K4c against their twins and
                  against K2, K3, K4 per chain (bit-identical) at both
                  shapes (24^3 x 6: SU(3)); every K1ac instantiation over
                  the 8 stages of a sweep on the shards of 8^4 on (2,2,1,1)
                  with 3 chains (the shape and mesh of its own phase-5
                  scan), and SU(3) HB, OR and tracked HB at 24^3 x 6 on
                  (2,2,1,1) with the scan's 11 chains, the halo refresh
                  between stages, against its plain twin and K1a on every
                  chain's padded arrays (|d| 0, per-chain counts equal);
                  SU(3) HB and OR the same way at the chain blocks of
                  phase 5's other mesh scans: 32^4 with 2 chains and with
                  1, 12^3 x 6 with each 2-chain block of the
                  CLI scan; K5ac/K5bc against their twins and bit-identical
                  to K5a/K5b per chain, and K2c on padded arrays
                  bit-identical to K2 per chain, at all of these shapes;
  4. timing     — each instantiation and its plain version at 32^4, CUDA
                  events, in the order plain, kernel, kernel (K2
                  over the 8 arrays in turn, per array), beside its bound
                  from bytes (a stream stage's state words included; on a
                  shard only the halo columns read), f32 operations and
                  threefry's and Philox's integer operations, each
                  operation kind at its own pipe's rate, and the f32
                  floor of a -fmad=false build;
                  K1a, K5a and K5b on one shard of 32^4 mesh (2,2,1,1),
                  and the halo refresh of one array; every K1c
                  instantiation, K2c, K3c and K4c at 24^3 x 6 with 11
                  chains, each beside the loop of 11 single-chain launches
                  on the chain views that it replaces, its bound C times
                  the single chain's; every K1ac instantiation, K5ac and
                  K5bc on shard 0 of 24^3 x 6 on (2,2,1,1) with 11 chains,
                  beside the loop of 11 K1a (K5a, K5b) launches; every
                  timed row also on the device by torch.profiler (the
                  record's device_ms: all the device work of a call, per
                  launch of the row's kernel, the K4 family's finish
                  kernel included; a stream stage's its stage kernel),
                  which CUDA events around back-to-back calls cannot
                  give below ~0.05 ms, with bound / device beside it;
  5. main paths — first small hot starts through the library API, CUDA
                  against the CPU path (threefry slices, and ranlux3).
                  Then Simulation(cfg) with no device argument at 32^4
                  (cold start, reunit_every=10, threefry): warmup(),
                  thermalize(20), run(20, 1), with the launch counters
                  zeroed before and read after each run, for the bench's
                  SU(3) heat-bath configuration (bench.py), the three slice
                  configurations (SU(3) heat-bath + 1 overrelaxation with
                  track_kp_exhaust; SU(3) Metropolis with track_acceptance;
                  SU(2) heat-bath + 1 overrelaxation) and four more that
                  drive the remaining instantiations; for the slice
                  configurations the device idle share from torch.profiler.
                  Then the PRNGCL stream path: SU(3) heat-bath at 32^4 with
                  ranlux3 (QCDGPU's default generator; idle share too),
                  ranmar, xor128 and mrg32k3a, with the time to build the
                  stream state; the bench's exact configuration with
                  rng_mode="hw" (Philox; launch counts, idle share); and
                  every stream and Philox instantiation through its own
                  configuration at 8^4.  Then the sharded path: the bench
                  configuration, threefry and hw, on mesh (2,2,1,1)
                  (launch counts, idle share, links bit-identical to the
                  unsharded run),
                  meshes (4,1,1,1) and (1,4,1,1), prngcl:ranlux3 on
                  (2,1,1,1) (links and streams bit-identical), and SU(3)
                  64^4 on (1,8,1,1) against unsharded after 2 sweeps;
                  and every K1a instantiation through a configuration of
                  its own at 8^4 on an X, Y or XY mesh.  Then the command
                  line on the bench's hw configuration: `cli.main(["run",
                  ..., "--ckpt-every", "5"])` and `resume`, each with
                  exact launch counts, whose series and links must equal
                  an uninterrupted run's; the native analysis library
                  (native/analysis.cpp, g++ at the run's first
                  analyze_series) built and loaded, g++'s message
                  otherwise, each of its estimators within 1e-12 of its
                  numpy twin on the run's plaquette series and a seeded
                  AR(1) series, both records' analysis analyze_series of
                  their series bit for bit, with the backend and its
                  seconds.  Then the beta scan (BASELINE
                  config 3): BetaScan(baseline_config(3), 5.6:6.1:11),
                  SU(3) 24^3 x 6 HB + 2 OR cold, threefry and hw,
                  warmup(), thermalize(20), run(20, 1) with exact launch
                  counts (24 K1c launches per sweep for the 11 chains),
                  ms/sweep and idle share, every chain bit-identical to
                  its own Simulation (seed + 1000 c, betas[c]; links and
                  series), which run one after the other for the time
                  they take; the same scans on mesh (2,2,1,1) (the chain x
                  lattice scan: 96 K1ac launches per sweep), every chain's
                  links bit-identical to the unsharded scan's and its
                  series within 1e-6, and bit-identical to its sharded
                  Simulation on the mesh; the reference's layout example,
                  2 chains of 32^4 on (2,2,1,1), chain_mesh 2 bit-identical
                  to 1; every K1c and K1ac instantiation's own 3-chain 8^4
                  scan, unsharded and on (2,2,1,1); `cli.main(["scan",
                  ...])` 10 + 10 sweeps then `scan --resume-state` for 10,
                  with exact launch counts, whose series and links must
                  equal an uninterrupted scan's, and the same at 12^3 x 6
                  with `--mesh 2,2,1,1 --chain-mesh 2`, resumed with
                  `--chain-mesh 1`;
  6. physics    — through the port's validate.py (its anchors, windows and
                  chains): SU(3) 16^4 beta=6.0 heat-bath (window 0.5937 +-
                  5e-4) and the same on mesh (2,2,1,1), which must
                  reproduce the unsharded chain's links and plaquette;
                  check_su3 (16^4 heat-bath + 1 overrelaxation,
                  track_kp_exhaust, seed 7) and check_su2 (8^4 beta=2.4
                  heat-bath, seed 42), each with the literature and
                  self-anchor gates, for threefry, a PRNGCL stream
                  (ranlux3; ranmar on SU(2)) and hw (Philox); SU(2) 8^4
                  beta=2.4 Metropolis with track_acceptance in the
                  literature window; check_deconfinement (BASELINE config
                  3: 24^3 x 6, beta 5.894 -+ 0.25, HB + 1 OR, 200 + 300
                  sweeps, one two-chain BetaScan) with threefry and hw,
                  each also on (2,2,1,1) in 2 chain blocks with the
                  unsharded <|P|> (within 1e-6);
                  `python -m qcdgpu_tpu_torch rngtest` with the native
                  host generators built;
  8. extended   — the extended observables (Fmunu, Wilson loops, clover
                  Q_L with APE smearing; PyTorch ops on the joined field)
                  and meas_dtype="double": (a) a hot 8^4 field, SU(3) and
                  SU(2), every option, the card against the CPU (1e-5 a
                  column, 2e-5 a smeared link); (b) at 32^4 the cold start
                  (|F|, |W - 1|, |Q| <= 1e-6) and the SU(3) abelian
                  two-flux background (Q_L exact within 1e-4, and two APE
                  steps leave it fixed: links within 2e-5, Q_L within
                  1e-3); (c) the bench's hw configuration with every
                  option at 32^4, thermalize(20) + run(20, 5) with exact
                  launch counts, W(1,1) = plq_t within 1e-5, measure()
                  the last row, the smeared field unitary within 1e-5,
                  the ms, device time, launches and peak memory of the
                  join, Fmunu, Wilson loops, Q_L, one APE step and the
                  whole measurement beside their bounds, ms/sweep with
                  and without the extras, and the same run on (2,2,1,1)
                  bit-identical; (d) docs/validation/wilson_su3.json's
                  run again, every <W(R,T)> and chi(2,2) within 4 sigma
                  combined of the record; (e) meas_dtype="double"
                  bit-identical to "same"; (f) a 3-chain 8^4 scan with
                  extras, each chain's rows its Simulation's; (g) the CLI
                  `run` + `resume` with extras bit-identical to an
                  uninterrupted run, with the Creutz ratios;
  9. dense      — the dense engine (dense.py: PyTorch ops, no kernel of
                  ours): (a) one stage of each kind, SU(3) and SU(2),
                  complex64 and complex128, threefry and xor128 (words
                  bit-identical), card against CPU at 8^4 within 2e-5 /
                  1e-10, and the card's f32 sqrt and 1/sqrt correctly
                  rounded (the CPU's go through f64); (b) Simulation(cfg) with no device argument at
                  SU(3) 32^4, HB, cold, reunit_every=10, engine "xla":
                  complex128 and complex64 with meas_dtype "double"
                  (warmup(), thermalize(5), run(5, 1)) and prngcl:ranlux3
                  (2 + 2): ms/sweep unmeasured and measured, one sweep's
                  launches, device time and idle share by torch.profiler,
                  peak memory, the bound by bytes, and none of our kernels
                  launched; (c) validate config 6 (dense against packed:
                  |dlinks| < 1e-2, |dobs| < 1e-4, one stage < 2e-5) and
                  the SU(3) and SU(2) quick gates in complex128; (d) a
                  ranlux3 complex128 run at 8^4 saved, loaded and
                  continued bit-identical; (e) a 3-chain xor128 scan at
                  8^4, each chain bit-identical to its Simulation; (f)
                  the dense engine on a mesh, every shard on the card:
                  (b)'s complex128 run on (1,1,2,2) (5 + 5 sweeps) with
                  links torch.equal to (b)'s and the series within 1e-5,
                  its ms/sweep, launches, device busy time, idle share,
                  peak memory and halo copies; at 8^4, 2 sweeps each
                  against the unsharded dense run bit for bit, a Z/T mesh
                  under engine "auto", engine "xla" complex64 on
                  (2,2,1,1), ranlux3 and mrg32k3a on (1,2,1,1),
                  meas_dtype "double", complex128 SU(2) Metropolis, and
                  every extended observable on (2,1,1,2) (those columns
                  equal); a 3-chain xor128 scan on (1,1,2,1) in one chain
                  block and in 3, each chain its mesh Simulation; the CLI
                  `run --mesh 1,1,2,2 --dtype complex128` resumed with
                  `--mesh 2,1,1,1`, bit-identical to an uninterrupted
                  run; validate config 5 (the one-device fallback) PASS;
                  none of our kernels launched.

Any failed check raises and the script exits non-zero.  The last three
lines are the kernels' JSON record, the card's `nvidia-smi` name/power
line and {"ok": true, "device": {...}}.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""

import contextlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SMALL = (4, 4, 2, 4)
ODD_T2 = (8, 8, 8, 6)
BIG = (32, 32, 32, 32)
STREAM_SMALL_RUN = (8, 8, 8, 8)
SHARD_SMALL = (8, 8, 4, 4)  # K1a / K5 against their plain twins
MESH = (2, 2, 1, 1)
# the X, Y and XY meshes the K1a instantiations' own 8^4 runs cycle over
SHARD_MESHES = ((2, 2, 1, 1), (4, 1, 1, 1), (1, 4, 1, 1), (2, 1, 1, 1),
                (1, 2, 1, 1))
GROUPS = (3, 2)
BETA_HOT = {3: 5.5, 2: 2.3}  # couplings of the kernel-vs-plain comparisons
BETA_RUN = {3: 6.0, 2: 2.4}
STAGE_TOL = 2e-5
REUNIT_TOL = 1e-6
PLANE_TOL = 1e-7  # |d sum| / (N * volume)
POLY_TOL = 2e-6   # |d sum| / (N * spatial volume)
FLIP_FRACTION = 1e-5  # accept flips at a rounding boundary, per link
# CUDA vs CPU at (4,4,2,4): first series row (plaquette/action, Polyakov),
# and the tracked column, which a few accept flips may move
ROW_TOL = (5e-5, 2e-4)
RATE_TOL = 2e-3
THERM, RUN = 20, 20
# the (parity, mu) stages of phase 3's K1, K1a, K1c and K1ac comparisons
# with their plain twins, in sweep order: all 8 at SMALL, and at every
# larger shape one of two halves, each with each parity and direction once
# (the host launch path of the plain twins is most of phase 3's time)
ALL_STAGES = tuple((p, mu) for p in (0, 1) for mu in range(4))
HALF_STAGES = (((0, 0), (0, 3), (1, 1), (1, 2)),
               ((0, 1), (0, 2), (1, 0), (1, 3)))
# (family, dims) -> the stages its comparisons at dims took so far
STAGES_TAKEN = {}


def sweep_stages(family, dims):
    """The (parity, mu) stages a phase-3 comparison of family ("K1",
    "K1a", "K1c", "K1ac") at dims takes: all 8 at SMALL; above it the two
    halves in turn, so that a family's calls at a shape take every stage
    between them (require_all_stages checks it)."""
    dims = tuple(dims)
    taken = STAGES_TAKEN.setdefault((family, dims), [])
    stages = ALL_STAGES if dims == SMALL else HALF_STAGES[len(taken) % 2]
    taken.append(stages)
    return stages


def require_all_stages():
    """Every family took every (parity, mu) stage at every shape."""
    short = {k: len(v) for k, v in STAGES_TAKEN.items()
             if {st for half in v for st in half} != set(ALL_STAGES)}
    require(not short, f"phase 3 comparisons that missed stages (calls): "
            f"{short}")
# the beta scan of BASELINE config 3 (K1c-K4c): its lattice and the CLI's
# example grid 5.6:6.1:11; 3 chains of distinct beta at SMALL
SCAN_DIMS = (24, 24, 24, 6)
SCAN_GRID = "5.6:6.1:11"
CHAIN_BETAS = {3: (5.5, 5.9, 6.3), 2: (2.1, 2.3, 2.5)}
# the chain x lattice scan (K1ac, K5ac, K5bc): config 3 on MESH, and the
# reference's own example of the layout (qcdgpu_tpu/parallel/mesh.py:
# 89-97), a 2-beta scan of 32^4 lattices on (2,2,1,1) in 2 chain blocks
LAYOUT_BETAS = (5.9, 6.1)
# the command line's scan on a mesh: 4 chains in 2 blocks
CLI_MESH_DIMS = (12, 12, 12, 6)
CLI_MESH_GRID = "5.6:6.1:4"
# K4 and K5b at the T/2 of phase 5's other paths: the SU(3) 16^4 gates
# (T/2 = 8) and 64^4 unsharded and on (1,8,1,1) (T/2 = 32); and T/2 = 36,
# where each of K4's lanes walks two slot pairs
GATE_DIMS = (16, 16, 16, 16)
HUGE, HUGE_MESH = (64, 64, 64, 64), (1, 8, 1, 1)
LONG_T = (2, 2, 2, 72)

# One H100 SXM, NVIDIA's data sheet: HBM bandwidth and f32 rate outside the
# tensor cores.  Integer operations run on their own pipe: 64 32-bit integer
# results per clock per SM (the CUDA C++ Programming Guide's throughput
# table, compute capability 9.0), times 132 SMs at the 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# f64 outside the tensor cores: 33.5 TFLOP/s on the data sheet, an FMA
# counted as two, so 1.675e13 f64 instructions a second (64 a clock an SM)
F64_OPS_PER_S = 33.5e12 / 2
# The f32 floor of a kernel built with -fmad=false (ops/cuda/build.py): no
# multiply-add contraction, so each f32 multiply and add is an instruction
# of its own, at one per lane per clock: 128 lanes x 132 SMs x 1.98 GHz,
# half the data sheet's FMA rate.  Printed beside the bound, not in it.
F32_INSTR_PER_S = 128 * 132 * 1.98e9

# Main-path runs of phase 5: (label, idle share measured (the bench and
# the slice configurations), SimConfig fields beyond dims=32^4, cold start,
# reunit_every=10, seed 0, threefry).
MAIN_PATHS = (
    ("bench: SU(3) heat-bath", True, dict(group=3, beta=6.0)),
    ("slice 1: SU(3) heat-bath + 1 OR, track_kp_exhaust", True,
     dict(group=3, beta=6.0, n_or=1, track_kp_exhaust=True)),
    ("slice 2: SU(3) Metropolis, track_acceptance", True,
     dict(group=3, beta=6.0, algorithm="metropolis", n_hit=3,
          metro_delta=0.35, track_acceptance=True)),
    ("slice 3: SU(2) heat-bath + 1 OR", True,
     dict(group=2, beta=2.4, n_or=1)),
    ("SU(3) Metropolis", False,
     dict(group=3, beta=6.0, algorithm="metropolis")),
    ("SU(2) heat-bath, track_kp_exhaust", False,
     dict(group=2, beta=2.4, track_kp_exhaust=True)),
    ("SU(2) Metropolis", False,
     dict(group=2, beta=2.4, algorithm="metropolis")),
    ("SU(2) Metropolis, track_acceptance", False,
     dict(group=2, beta=2.4, algorithm="metropolis", track_acceptance=True)),
)
# The PRNGCL stream path: the bench configuration with QCDGPU's default
# generator (ranlux3, the slice) and the stream rows of the reference's
# perf matrix, SU(3) heat-bath at 32^4, cold start, reunit_every=10.
STREAM_BIG = ("ranlux3", "ranmar", "xor128", "mrg32k3a")
# the generator standing for each family where one is timed
FAMILY_GEN = {"xor128": "xor128", "xor7": "xor7", "mrg32k3a": "mrg32k3a",
              "parkmiller": "parkmiller", "constant": "constant",
              "ranlux": "ranlux3", "ranmar": "ranmar"}
# the random sources that drive each family's 8 instantiations at 8^4 in
# turn: PRNGCL generators, and "hw" (Philox) for the philox family
FAMILY_RUN_GENS = {"ranlux": ("ranlux0", "ranlux1", "ranlux2", "ranlux4"),
                   "xor128": ("xor128",), "xor7": ("xor7",),
                   "mrg32k3a": ("mrg32k3a",), "parkmiller": ("parkmiller",),
                   "constant": ("constant",), "ranmar": ("ranmar",),
                   "philox": ("hw",)}
DRAWING = ("heatbath", "metropolis")
# the ranlux luxury counters of phase 3's sweep of K8's schedule: fresh,
# one draw in, and a skip one draw or no draw away
K8_NB0 = (0, 1, 23, 24)
# and its longer stages: KP trials (a ranlux subgroup of 34 draws; ranmar's
# 102 draws pass its 97 slots and ask more than 48 KB of shared memory),
# Metropolis hits (a ranlux subgroup of 100 draws: past 48 KB too)
K8_TRIALS = 8
K8_HITS = 25
# and subgroups past a chunk of Ranlux::kMaxPer = 413 draws, which the kernel
# makes in chunks: (kind, KP trials, hits, group): SU(3) Metropolis with
# 110 hits (440 draws a subgroup, two chunks), SU(2) heat-bath with 210 KP
# trials (842 draws, three chunks); each also through Simulation at 8^4
K8_LONG = (("metropolis", 4, 110, 3), ("heatbath", 210, 3, 2))
# the generator of each K8_LONG case where it runs alone (phases 3 and 4)
K8_LONG_GENS = ("ranlux3", "ranlux4")

# A random source ("src" below) is None (threefry), "hw" (Philox) or a
# PRNGCL generator name.


def is_stream(src):
    return src not in (None, "hw")


def rng_mode_of(src):
    return ("threefry" if src is None else "hw" if src == "hw"
            else f"prngcl:{src}")


def parse_instance(name):
    """(kind, group, tracked, family or None) of a stage instantiation's
    name (update.instance_name): a stream family, "philox" or None
    (threefry)."""
    parts = name.split("_")
    fam = parts[3] if parts[3:4] and parts[3] in FAMILY_RUN_GENS else None
    return parts[1], int(parts[2][2:]), "track" in parts, fam


def is_stream_row(name):
    """Whether a kernel record row is a stream stage (K1 or K1a drawing from
    a PRNGCL family)."""
    return name.startswith("stage_") and parse_instance(name)[3] in FAMILY_GEN


def family_source(fam):
    """The source standing for family fam where one stands for it."""
    return "hw" if fam == "philox" else FAMILY_GEN.get(fam)


def instance(kind, n, track, src, shard=False):
    """update.instance_name of the instantiation that source src runs."""
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate

    return cupdate.instance_name(kind, n, track,
                                 src if is_stream(src) else None, shard,
                                 philox=src == "hw" and kind != "overrelax")


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s",
                  flush=True)
        return False


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_lines():
    """The `name, power.limit` line of every card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


def sync():
    torch.cuda.synchronize()


def clone(us):
    return tuple(a.clone() for a in us)


def event_ms(fn, reps, warm=True):
    """Mean ms per call of fn over reps calls, after one warm-up call
    (none without warm: for a plain twin whose kernels are all warm)."""
    if warm:
        fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# ptxas summary
# ---------------------------------------------------------------------------


def kernel_label(mangled, kinds):
    """Readable name of a mangled qg:: kernel; stage instantiations get
    their launch-counter names (kinds: the update kinds in qg::Kind
    order)."""
    shard = "_shard" if "9ShardDims" in mangled else ""
    m = re.search(r"stage_(chains_)?kernelILi(\d)ELi(\d)ELb([01])ENS_"
                  r"(?:8Threefry|(6Philox)|6StreamINS_(\d+)(\w+))", mangled)
    if m:
        n, kind, track = int(m[2]), kinds[int(m[3])], m[4] == "1"
        fam = ("_philox" if m[5] else "" if m[6] is None
               else "_" + m[7][:int(m[6])].lower())
        # Ranlux<true>: the instantiation of subgroups past a column's draws
        chunked = m[6] is not None and m[7][int(m[6]):].startswith("ILb1E")
        return (f"stage_{kind}_su{n}{fam}" + ("_track" if track else "")
                + shard + ("_chains" if m[1] else "")
                + ("_chunked" if chunked else ""))
    m = re.match(r"_ZN2qg(\d+)", mangled)  # qg::<length-prefixed name>
    if not m:
        return mangled
    end = m.end() + int(m[1])
    t = re.match(r"ILi(\d)E", mangled[end:])
    return mangled[m.end():end] + (f"<{t[1]}>" if t else "") + shard


def ptxas_summary(log, kinds):
    """[(kernel, 'N registers, S bytes stack frame, spills', mangled name)]
    from nvcc's -Xptxas -v output."""
    rows, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, mangled, frame = kernel_label(m[1], kinds), m[1], ""
            continue
        if "stack frame" in line and name:
            frame = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, f"{m[1]} registers; {frame}", mangled))
            name = None
    return rows


def frame_and_spills(line):
    """(stack frame bytes, spill store + load bytes) of a ptxas_summary
    line."""
    num = [int(re.search(rf"(\d+) bytes {k}", line)[1])
           for k in ("stack frame", "spill stores", "spill loads")]
    return num[0], num[1] + num[2]


def needs_no_frame(name):
    """The K1 (stage_*, with K1a and K1c, every random source), K3
    (plane_sums_kernel and plane_sums_tile_kernel, with K3c and K5a) and
    K4 (polyakov_sums_kernel, with K4c, K5b and K5bc) instantiations keep
    everything in registers and shared memory: no stack frame, no
    spills."""
    return name.startswith(("stage_", "plane_sums_kernel",
                            "plane_sums_tile_kernel", "polyakov_sums_kernel"))


# SASS opcode classes (by mnemonic prefix), for the static instruction mix
SASS_CLASSES = (
    ("f32", ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET",
             "MUFU", "FRND", "FCHK")),
    ("f64", ("DADD", "DMUL", "DFMA", "DSETP")),
    ("integer", ("IADD", "IMAD", "LOP", "SHF", "ISETP", "IABS", "LEA",
                 "IMNMX", "SEL", "PRMT", "POPC", "FLO", "BREV", "I2F", "F2I",
                 "VIADD", "VIMNMX", "UIADD", "UIMAD", "ULOP", "USHF",
                 "ULEA", "UISETP", "USEL", "UPRMT")),
    ("global load", ("LDG",)), ("global store", ("STG",)),
    ("shared", ("LDS", "STS")), ("local", ("LDL", "STL")),
    ("constant", ("LDC", "ULDC")), ("shuffle", ("SHFL",)),
)


def sass_mix(lib_path, mangled):
    """{class: count} of the SASS instructions of one kernel in the built
    library (cuobjdump, static: a loop's body counts once), or None when
    the toolkit has no cuobjdump."""
    from qcdgpu_tpu_torch.ops.cuda import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", "-fun", mangled, str(lib_path)],
                         capture_output=True, text=True, check=True).stdout
    mix = {k: 0 for k, _ in SASS_CLASSES}
    mix["generic"] = mix["other"] = 0
    for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                         out):
        op = m[1]
        cls = "generic" if op in ("LD", "ST") else next(
            (k for k, pre in SASS_CLASSES if op.startswith(pre)), "other")
        mix[cls] += 1
    return mix


# ---------------------------------------------------------------------------
# bounds: bytes each call must move and f32 operations it must do
# ---------------------------------------------------------------------------


def mmul_ops(n):
    """f32 operations of one complex n x n product: n^2 entries of n
    complex multiplies (6 each) and n - 1 complex adds (2 each)."""
    return n * n * (8 * n - 2)


def codec_ops(n):
    """SU(3) rebuilds row 2 on every load: 3 x (2 complex multiplies + 1
    complex subtract); SU(2) stores its whole matrix."""
    return 42 if n == 3 else 0


# f32 operations per subgroup touch, counted from csrc/stage.cu: the
# heat-bath's set-up, one Kennedy-Pendleton trial and its direction +
# product; the overrelaxation flip; one Metropolis hit.
HB_SETUP, HB_TRIAL, HB_FINISH = 19, 97, 89
OR_FLIP = 42
METRO_HIT = 134
# Integer operations of one call of a counter-based source
# (csrc/common.cuh): threefry2x32-20, 2 key adds, 20 rounds of add, rotate
# (one funnel shift: the rotations are constants) and xor, 5 key
# injections of 3 adds, 2 xors for the parity key; Philox-4x32-10, 10
# rounds of two 32x32->64 multiplies (one wide multiply-add each) and 4
# xors, 9 key bumps of 2 adds.
THREEFRY_CALL_OPS = 20 * 3 + 2 + 5 * 3 + 2
PHILOX_CALL_OPS = 10 * (2 + 4) + 9 * 2
# (integer, f64) operations of one draw of a stream generator
# (csrc/streams.cuh), its recurrence's own, counted in the SASS of K1 SU(3)
# heat-bath (phase 2 prints its mix beside the constant stream's; the
# heat-bath's code holds 18 draws, 6 a subgroup): xor128 5 (3 shifts, 3
# xors, two of them one three-input op), xor7 13 (7 shifts and 7 xors),
# mrg32k3a 17 f64 (mrg_step twice: a multiply, three FMAs, an add, a
# compare and a conditional add; the output's subtract, compare and add)
# and no integer one; parkmiller Schrage's step, a multiply-high division
# (2), 3 multiply-adds and the wrap (2); ranmar its carry's subtract,
# compare and select (its ~6 f32 operations a draw are not counted);
# constant none.  Ranlux costs SWB_STEP_OPS a subtract-with-borrow step (a
# three-input add, the borrow by a shift, the 24-bit mask), one step a
# draw and skip_len more a luxury skip.
STREAM_DRAW_OPS = {"xor128": (5, 0), "xor7": (13, 0), "mrg32k3a": (0, 17),
                   "parkmiller": (7, 0), "ranmar": (3, 0), "constant": (0, 0)}
SWB_STEP_OPS = 3


def rng_ops_per_site(n, kind, k_trials, n_hit, fam, gen=None):
    """(integer, f64) operations of a site's draws: one threefry call per slot,
    one Philox call per block of two slots (the kernel keeps the last
    block, and the slots are drawn in ascending order), or a stream
    generator's steps for the stage's draws (gen: the generator, for the
    ranlux level; FAMILY_GEN's by default).  A ranlux luxury skip fires
    every 24 draws, so draws / 24 of them a stage over consecutive
    stages."""
    from qcdgpu_tpu_torch.ops import prng_streams as ps
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate

    per = cupdate.uniforms_per_subgroup(kind, k_trials, n_hit)
    slots = (3 if n == 3 else 1) * ((per + 1) // 2)
    if fam is None:
        return THREEFRY_CALL_OPS * slots, 0
    if fam == "philox":
        return PHILOX_CALL_OPS * ((slots + 1) // 2), 0
    draws = cupdate.stream_draw_count(kind, k_trials, n_hit, n)
    if fam == "ranlux":
        skip = ps.ranlux_skip_len(gen or FAMILY_GEN[fam])
        return SWB_STEP_OPS * draws * (1 + skip / 24), 0
    int_ops, f64_ops = STREAM_DRAW_OPS[fam]
    return int_ops * draws, f64_ops * draws


def stage_ops_per_site(n, kind, k_trials, n_hit):
    """f32 operations of a site's stage, the heat-bath's k_trials counted
    in full (the kernel skips a site's trials after its first accepted one,
    so this is the most the data can need; every stage's bound is its
    bytes' all the same)."""
    staples = 13 * mmul_ops(n) + 5 * 2 * n * n + 19 * codec_ops(n)
    flip = {"heatbath": HB_SETUP + k_trials * HB_TRIAL + HB_FINISH,
            "overrelax": OR_FLIP, "metropolis": n_hit * METRO_HIT}[kind]
    n_sg = 3 if n == 3 else 1
    # per subgroup: the quaternion (8) and two left multiplications (28 n)
    return staples + n_sg * (8 + 56 * n + flip)


def stream_word_bytes(gen, v2, ndraw, scalars):
    """Bytes of state words one stream stage must move at v2 active sites:
    each word it reads before writing it, read once, and each word it
    writes, written once.  ndraw >= 24 touches every word of the
    counter-free and ranlux states; ranmar touches the slots its pointer
    and lag reach, from this call's pointer."""
    from qcdgpu_tpu_torch.ops import prng_streams as ps

    fam = ps.family(gen)
    if fam == "constant":
        return 4 * v2  # read, never written
    if fam != "ranmar":
        return 8 * ps.stream_word_count(gen) * v2
    read, written = set(), set()
    for t in range(ndraw):
        i = (scalars["ptr"] - t) % 97
        read.update(k for k in (i, (i - 64) % 97) if k not in written)
        written.add(i)
    return 4 * v2 * (len(read) + len(written))


def unit(axis):
    """(dx, dy) of one step along lattice axis 0..3 (Z, T stay in the
    column)."""
    return ((1, 0), (0, 1), (0, 0), (0, 0))[axis]


def stage_reads(mu, p):
    """The links one stage (mu, parity p) loads, as (array 2d + parity,
    dx, dy): U_mu(x), and per nu != mu the staple's U_nu(x), U_mu(x+nu),
    U_nu(x+mu), U_nu(x+mu-nu), U_mu(x-nu), U_nu(x-nu)."""
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
    """The links the plane sums load over both parities: U_mu(x),
    U_nu(x+mu), U_nu(x), U_mu(x+nu) for each plane (mu, nu)."""
    reads = []
    for p in (0, 1):
        for mu, nu in itertools.combinations(range(4), 2):
            reads += [(2 * mu + p, 0, 0), (2 * nu + 1 - p, *unit(mu)),
                      (2 * nu + p, 0, 0), (2 * mu + 1 - p, *unit(nu))]
    return reads


def columns_read(reads, local, halo):
    """Distinct (array, X/Y column) pairs that ``reads`` touch when applied
    to every interior column of a shard: a column holds all Z*T/2 slots of
    its array, a split axis steps into the halo, an axis that is not split
    wraps."""
    lx, ly = local
    cols = set()
    for k, dx, dy in reads:
        for x in range(lx):
            for y in range(ly):
                cols.add((k, x + dx if halo[0] else (x + dx) % lx,
                          y + dy if halo[1] else (y + dy) % ly))
    return len(cols)


def plane_decodes(dims, shard):
    """Links a site of K3 loads and decodes: its 16 distinct links, or with
    the tile kernel (the whole lattice with Z*T/2 a multiple of 128:
    csrc/measure.cu tile_fits) its own 4 and its 6 x and y neighbours,
    plus the 4 links of each slot of the line after each 128-slot tile."""
    t2 = dims[3] // 2
    if shard is None and 128 % t2 == 0 and dims[2] * t2 % 128 == 0:
        return 10 + 4 * t2 / 128
    return 16


def work(name, dims, k_trials=4, n_hit=3, shard=None, mu=1, parity=0):
    """(bytes, f32, integer and f64 operations) of one call of kernel
    `name` at dims: each input read once, each output written once (a
    stream stage's words are added by the caller: stream_word_bytes).  A
    stage is stage (mu, parity).  With shard (a core.Shard: K1a, K5a, K5b)
    dims are its interior extents, and of its padded arrays only the halo
    columns that the call reads count."""
    n = int(re.search(r"_su(\d)", name)[1])
    v2 = int(np.prod(dims)) // 2
    arr = 16 * n * v2  # one packed (direction, parity) array
    col = arr // (dims[0] * dims[1])  # one X/Y column of it
    local, halo = ((dims[0], dims[1]), (0, 0)) if shard is None else (
        shard.local, shard.halo)
    if name.startswith("stage_"):
        # the links the stage loads, the target written
        kind, _, _, fam = parse_instance(name)
        int_ops, f64_ops = rng_ops_per_site(n, kind, k_trials, n_hit, fam)
        return (columns_read(stage_reads(mu, parity), local, halo) * col
                + arr, v2 * stage_ops_per_site(n, kind, k_trials, n_hit),
                v2 * int_ops, v2 * f64_ops)
    if name.startswith("reunit_"):
        return 2 * arr, v2 * (84 if n == 3 else 23), 0, 0
    if name.startswith("plane_sums"):
        per_site = (6 * (2 * mmul_ops(n) + 4 * n * n)
                    + plane_decodes(dims, shard) * codec_ops(n))
        return (columns_read(plane_reads(), local, halo) * col + 6 * 8,
                2 * v2 * per_site, 0, 0)
    x, y, z, t = dims  # polyakov_sums: the temporal arrays only
    per_col = (t - 1) * mmul_ops(n) + t * codec_ops(n) + 2 * (n - 1)
    return 2 * arr + 2 * 8, x * y * z * per_col, 0, 0


def bound(nbytes, f32_ops, int_ops, f64_ops=0):
    """The least ms of a call: its bytes at the HBM rate, or its f32, its
    integer and its f64 operations each at its own pipe's rate, whichever
    is longest."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(f32_ops / F32_OPS_PER_S, int_ops / INT32_OPS_PER_S,
                f64_ops / F64_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# device idle share
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_window(sim, n_sweeps):
    """thermalize(n) + run(n, 1) twice: on the host clock alone, then under
    torch.profiler.  Returns (host wall ms, host wall ms under the
    profiler, device busy ms, {kernel name: (ms, calls)}) with busy from
    the trace's device events; busy is None when the trace holds none.
    The profiler slows the host loop, not the kernels, so the idle share
    is taken against the unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    def window():
        sim.sync()
        t0 = time.perf_counter()
        sim.thermalize(n_sweeps)
        sim.run(n_sweeps, 1)
        sim.sync()
        return (time.perf_counter() - t0) * 1e3

    wall = window()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = window()
    by_name = device_events(prof)
    if not by_name:
        return wall, wall_prof, None, {}
    busy = sum(ms for ms, _ in by_name.values())
    return wall, wall_prof, busy, by_name


def trace_events(prof):
    """The chrome-trace events of a finished torch.profiler trace."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def device_events(prof):
    """{name: (device ms, calls)} of a finished torch.profiler trace's
    device events (kernels, copies, memsets)."""
    by_name = {}
    for e in trace_events(prof):
        if e.get("cat") in DEVICE_CATS:
            ms, calls = by_name.get(e["name"], (0.0, 0))
            by_name[e["name"]] = (ms + e["dur"] / 1e3, calls + 1)
    return by_name


def device_ms(fn, reps, match):
    """Device ms per call of fn, over reps calls under torch.profiler after
    one warm-up call: (the kernels whose name holds match, all the calls'
    device work), or (None, None) when the trace holds no device event.
    Unlike CUDA events around back-to-back calls it does not count the
    host's launch path.  A trace now and then comes back with no device
    event at all (once in 112 short windows on the H100): up to three
    windows are taken."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            sync()
        by_name = device_events(prof)
        if by_name:
            break
    else:
        return None, None
    return (sum(ms for k, (ms, _) in by_name.items() if match in k) / reps,
            sum(ms for ms, _ in by_name.values()) / reps)


# ---------------------------------------------------------------------------
# the native analysis library (native/analysis.cpp, built with g++)
# ---------------------------------------------------------------------------

ANALYSIS_RTOL = 1e-12  # native estimator against its numpy twin


def ar1_series(n, seed=5, rho=0.8):
    """0.6 + 0.01 x with x a seeded AR(1) chain: an autocorrelated series
    like a Markov-chain observable."""
    eps = np.random.default_rng(seed).normal(size=n)
    x = np.empty(n)
    x[0] = 0.0
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]
    return 0.6 + 0.01 * x


def same_float(a, b, rtol=0.0):
    """a == b (NaN equal to NaN), or within rtol of b."""
    a, b = float(a), float(b)
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= rtol * abs(b)


def analysis_check(recs, plq, smi):
    """The native analysis library on this machine: it builds (g++'s
    message otherwise) and loads; each of its estimators equals its numpy
    twin within ANALYSIS_RTOL on the bench's plaquette series plq and a
    seeded AR(1) series; and each CLI record's analysis (recs, written by
    Simulation.analysis() in the CLI run) is analyze_series of the record's
    own series bit for bit.  The library was loaded at that run's first
    analyze_series and the load is cached, so available() now says which
    backend the run took."""
    from qcdgpu_tpu_torch.native import analysis as nat
    from qcdgpu_tpu_torch.native import build as nbuild
    from qcdgpu_tpu_torch.utils import stats

    try:
        path = nbuild.build_lib("analysis", ["analysis/analysis.cpp"])
    except nbuild.NativeBuildError as e:
        raise AssertionError(
            f"the native analysis library did not build: {e}") from e
    require(nat.available(), f"{path.name} is built but did not load when "
            "the CLI run analysed its series")
    bad = []
    for label, x in (("bench hw plaquette", np.asarray(plq, np.float64)),
                     ("AR(1) 2048", ar1_series(2048))):
        n = len(x)
        got = {"series_moments": nat.series_moments(x)}
        want = {"series_moments": (x.mean(), x.var(),
                                   np.sqrt(x.var(ddof=1) / n))}
        for bs in (1, 2, 4, 16):
            got[f"binned_error {bs}"] = (nat.binned_error(x, bs),)
            want[f"binned_error {bs}"] = (stats.binned_error(x, bs),)
        for bs in (1, 2):
            got[f"jackknife_mean {bs}"] = nat.jackknife_mean(x, bs)
            want[f"jackknife_mean {bs}"] = stats.jackknife(x, np.mean, bs)
        err_naive = np.sqrt(x.var(ddof=1) / n)
        best, best_bs, bs = err_naive, 1, 2
        while n // bs >= 8:
            e = stats.binned_error(x, bs)
            if np.isfinite(e) and e > best:
                best, best_bs = e, bs
            bs *= 2
        got["plateau_error"] = nat.plateau_error(x, 8)
        want["plateau_error"] = (best, best_bs)
        lags = min(20, n - 1)
        xc = x - x.mean()
        rho = nat.autocorr(x, lags)
        rho_np = [np.dot(xc[:n - k], xc[k:]) / ((n - k) * x.var())
                  for k in range(lags + 1)]
        worst = 0.0
        for k in got:
            for a, b in zip(got[k], want[k]):
                if not same_float(a, b, ANALYSIS_RTOL):
                    bad.append(f"{label} {k}: {a!r} vs numpy {b!r}")
                elif np.isfinite(b) and b:
                    worst = max(worst, abs(a - b) / abs(b))
        d_rho = float(np.max(np.abs(rho - rho_np)))
        if not d_rho <= ANALYSIS_RTOL:  # rho[0] = 1
            bad.append(f"{label} autocorr: max |d| {d_rho:.3e}")
        print(f"analysis {label} (n {n}): the native estimators against "
              f"numpy, worst rel {worst:.3e}, autocorr max |d| {d_rho:.3e} "
              f"(< {ANALYSIS_RTOL})")
    require(not bad, "native estimators differ from numpy: " + "; ".join(bad))
    t0 = time.perf_counter()
    n_cols = 0
    for label, rec in zip(("run", "resume"), recs):
        for name, series in rec["series"].items():
            got = rec["results"][name]
            want = stats.analyze_series(
                np.asarray(series, np.float64)).to_dict()
            n_cols += 1
            require(got.keys() == want.keys() and all(
                same_float(got[k], v) for k, v in want.items()),
                f"CLI {label} record's analysis of {name} {got} is not "
                f"analyze_series {want}")
    secs = time.perf_counter() - t0
    print(f"analysis backend: native ({path.name}, g++); the CLI run's and "
          f"resume's records equal analyze_series of their {n_cols} series "
          f"bit for bit, which took {secs:.4f} s on the host  [{smi}]")


def dense_across_cards(cards, smi):
    """The dense engine on DENSE_MESH with its shards on ``cards`` (shard k
    on card k % N): (b)'s complex128 SU(3) 32^4 configuration, 2 + 2
    sweeps, against card 0's unsharded dense run (links bit-identical,
    series within 1e-5); ms/sweep, and one sweep under torch.profiler:
    launches and device busy ms per card, and each card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    from qcdgpu_tpu_torch import SimConfig, Simulation

    cfg = SimConfig(group=3, beta=6.0, dims=BIG, reunit_every=10,
                    start="cold", seed=0, dtype="complex128", engine="xla")
    out = []
    for m, devices in (((1, 1, 1, 1), None), (DENSE_MESH, cards)):
        sim = Simulation(cfg.replace(mesh=m), device="cuda:0",
                         devices=devices)
        sim.warmup()
        t0 = time.perf_counter()
        sim.thermalize(2)
        obs = sim.run(2, 1)
        sim.sync()
        ms = (time.perf_counter() - t0) / 4 * 1e3
        out.append((sim.u.cpu(), obs, ms,
                    sorted({str(d) for d in sim._run.grid.devices})))
    (u1, o1, ms1, _), (un, on, msn, used) = out
    same = torch.equal(u1, un)
    dobs = float(np.max(np.abs(o1 - on)))
    # one sweep of the mesh run on the host clock, then under the profiler
    sim.sync()
    t0 = time.perf_counter()
    sim.thermalize(1)
    sim.sync()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.thermalize(1)
        sim.sync()
    busy = device_busy_by_card(prof)
    per_card = "; ".join(
        f"cuda:{d} {ms:.1f} ms busy in {n} launches, idle share "
        f"{1.0 - ms / wall:.3f}" for d, (ms, n) in sorted(busy.items()))
    print(f"dense complex128 SU(3) {BIG}: mesh {DENSE_MESH} on {used} vs "
          f"unsharded on cuda:0, thermalize(2) + run(2, 1): links "
          f"bit-identical {same}, series max |d| {dobs:.1e}; {msn:.1f} vs "
          f"{ms1:.1f} ms/sweep; one mesh sweep {wall:.1f} ms host: "
          f"{per_card or 'device time not measured (empty trace)'}  "
          f"[{smi}]")
    require(same and dobs < 1e-5
            and len(used) == min(len(cards), int(np.prod(DENSE_MESH))),
            "dense mesh across the cards differs")


def device_busy_by_card(prof):
    """{card index: (device ms, launches)} of a finished torch.profiler
    trace's device events."""
    out = {}
    for e in trace_events(prof):
        if e.get("cat") in DEVICE_CATS:
            d = int(e.get("args", {}).get("device", -1))
            ms, n = out.get(d, (0.0, 0))
            out[d] = (ms + e["dur"] / 1e3, n + 1)
    return out


def multicard(n_cards):
    """``--cards N``: the sharded path with its shards spread over N cards
    (Simulation(cfg, devices=[cuda:0 .. cuda:N-1]), halo copies between
    cards) against the unsharded chain on card 0: links, series and
    stream state bit-identical; then dense_across_cards.  Prints each
    card's nvidia-smi line and the contract's last line with count N."""
    from qcdgpu_tpu_torch import SimConfig, Simulation
    from qcdgpu_tpu_torch.ops.cuda import build

    require(torch.cuda.device_count() >= n_cards,
            f"{n_cards} cards asked for, {torch.cuda.device_count()} present")
    cards = [f"cuda:{i}" for i in range(n_cards)]
    with Phase("1 device"):
        smi = nvidia_smi_lines()
        print("cards:", smi)
    with Phase("2 build"):
        print(f"library built in {build.build()['seconds']:.1f} s")
        build.library()
    bench = SimConfig(group=3, beta=6.0, dims=BIG, reunit_every=10,
                      start="cold", seed=0)
    x_only = (n_cards, 1, 1, 1)
    xy = (2, n_cards // 2, 1, 1) if n_cards % 2 == 0 else x_only
    runs = (("bench SU(3) heat-bath", bench, xy),
            ("SU(3) heat-bath + 1 OR, track_kp_exhaust, hot start",
             bench.replace(n_or=1, track_kp_exhaust=True, start="hot"),
             x_only),
            ("SU(3) heat-bath, prngcl:ranlux3", bench.replace(
                rng_mode="prngcl:ranlux3"), xy),
            # stages asking more than 48 KB of shared memory (a kernel
            # attribute each card must be given)
            (f"SU(3) heat-bath, {K8_TRIALS} KP trials, prngcl:ranmar",
             bench.replace(kp_trials=K8_TRIALS, rng_mode="prngcl:ranmar"),
             xy),
            (f"SU(2) Metropolis, {K8_HITS} hits, prngcl:ranlux3",
             bench.replace(group=2, beta=2.4, algorithm="metropolis",
                           n_hit=K8_HITS, rng_mode="prngcl:ranlux3"), xy))
    with Phase(f"7 shards on {n_cards} cards"):
        for label, cfg, mesh in runs:
            out = []
            for m, devices in (((1, 1, 1, 1), None), (mesh, cards)):
                sim = Simulation(cfg.replace(mesh=m), device="cuda:0",
                                 devices=devices)
                sim.warmup()
                t0 = time.perf_counter()
                sim.thermalize(10)
                obs = sim.run(10, 1)
                sim.sync()
                ms = (time.perf_counter() - t0) / 20 * 1e3
                out.append((tuple(a.cpu() for a in sim.us), obs,
                            sim.stream_state, ms,
                            sorted({str(d) for d in sim._run.grid.devices})))
                del sim
            (u1, o1, s1, ms1, _), (un, on, sn, msn, used) = out
            same = (all(torch.equal(a, b) for a, b in zip(u1, un))
                    and np.array_equal(o1, on))
            if s1 is not None:
                same = same and all(np.array_equal(s1[k], sn[k]) for k in s1)
            print(f"{label}: mesh {mesh} on {used} vs unsharded on cuda:0, "
                  f"thermalize(10) + run(10, 1): links, series"
                  + (" and streams" if s1 is not None else "")
                  + f" bit-identical {same}; {msn:.3f} vs {ms1:.3f} "
                  f"ms/sweep  [{smi[0]}]")
            require(same and len(used) == n_cards,
                    f"{label}: mesh {mesh} on {n_cards} cards differs")
        # the chain x lattice scan with its chain blocks spread over the
        # cards (block b on card b) against one block on card 0: config 3's
        # lattice and sweep on MESH, 2 chains per card
        from qcdgpu_tpu_torch.models import BetaScan, baseline_config

        cfg = baseline_config(3).replace(mesh=MESH)
        betas = np.linspace(5.6, 6.1, 2 * n_cards)
        out = []
        for blocks, devices in ((1, None), (n_cards, cards)):
            scan = BetaScan(cfg, betas, blocks, device="cuda:0",
                            devices=devices)
            scan.warmup()
            t0 = time.perf_counter()
            scan.thermalize(10)
            obs = scan.run(10, 1)
            ms = (time.perf_counter() - t0) / 20 * 1e3
            used = sorted({str(d) for g in scan._run.grid.grids
                           for d in g.devices})
            out.append((tuple(a.cpu() for a in scan.us), obs, ms, used))
            del scan
        (u1, o1, ms1, _), (un, on, msn, used) = out
        same = (all(torch.equal(a, b) for a, b in zip(u1, un))
                and np.array_equal(o1, on))
        print(f"scan of {len(betas)} chains on mesh {MESH}: {n_cards} chain "
              f"blocks on {used} vs one block on cuda:0, thermalize(10) + "
              f"run(10, 1): links and series bit-identical {same}; "
              f"{msn:.3f} vs {ms1:.3f} ms/sweep  [{smi[0]}]")
        require(same and len(used) == n_cards,
                f"chain blocks on {n_cards} cards differ")
        # one measured block of phase 8's main path (c), the bench's hw
        # configuration with every extended option, on the XY mesh across
        # the cards against the unsharded run on card 0
        ext = extended_cfg(bench.replace(rng_mode="hw"))
        out = []
        for m, devices in (((1, 1, 1, 1), None), (xy, cards)):
            sim = Simulation(ext.replace(mesh=m), device="cuda:0",
                             devices=devices)
            sim.thermalize(5)
            out.append(sim.run(5, 5))
            del sim
        same = np.array_equal(out[0], out[1])
        print(f"bench hw with every extended option: one block of 5 sweeps "
              f"and a measurement on mesh {xy} over {n_cards} cards, the "
              f"row ({out[1].shape[1]} columns) bit-identical to the "
              f"unsharded run on cuda:0: {same}")
        require(same, "extended measurement across cards differs")
    with Phase(f"9 dense mesh on {n_cards} cards"):
        dense_across_cards(cards, smi[0])
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


# ---------------------------------------------------------------------------
# phase 8: the extended observables (Fmunu, Wilson loops, clover Q_L with
# APE smearing) and meas_dtype="double"
# ---------------------------------------------------------------------------

# tools/wilson_study.py's 10 loops, and docs/validation/wilson_su3.json's
# run: SU(3) 16^4 beta=6.0 heat-bath + 1 OR, seed 17, 300 + 500 sweeps
# measured every 2
WILSON_PAIRS = tuple((r, t) for r in range(1, 5) for t in range(1, 5)
                     if abs(r - t) <= 1)
WILSON_RECORD = "docs/validation/wilson_su3.json"
EXT_TOL = 1e-5        # card against CPU: an extended column
SMEAR_TOL = 2e-5      # card against CPU, and a fixed point: a smeared link
EXACT_TOL = 1e-6      # cold start: |F|, |W - 1|, |Q|
GATE_SIGMAS = 4.0


def extended_cfg(cfg, smear=2):
    """cfg with every extended option: the Cartan Fmunu projections,
    WILSON_PAIRS, Q_L after ``smear`` APE steps of weight 0.5."""
    return cfg.replace(get_fmunu=True, wilson_loops=WILSON_PAIRS,
                       get_qtop=True, qtop_smear=smear)


def abelian_two_flux(dims, k1=1, k2=1):
    """SU(3) links with constant abelian flux along T_3 = diag(1, -1, 0):
    B1 = 2 pi k1 / L in the xy plane (U_x ~ y), B2 in the zt plane (U_z ~
    t), U_y = U_t = 1 (tests/test_qtop.py's construction, in numpy).
    Returns (complex64 [4, 3, 3, *dims], Q_L exact = V sin B1 sin B2 /
    2 pi^2)."""
    x, y, z, t = dims
    b1, b2 = 2.0 * np.pi * k1 / y, 2.0 * np.pi * k2 / t
    u = np.zeros((4, 3, 3) + tuple(dims), np.complex64)
    for i in range(3):
        u[:, i, i] = 1.0
    ph1 = np.exp(1j * b1 * np.arange(y))
    ph2 = np.exp(1j * b2 * np.arange(t))
    for i, s in ((0, +1), (1, -1)):
        u[0, i, i] = (ph1 ** s)[None, :, None, None]
        u[2, i, i] = (ph2 ** s)[None, None, None, :]
    q = x * y * z * t * np.sin(b1) * np.sin(b2) / (2.0 * np.pi ** 2)
    return u, q


def wilson_line_products(pairs):
    """Matrix products per site of ops.measure.wilson_loop_means: one per
    memoized line beyond length 1, three per pair and spatial direction."""
    longest = max(r for r, _ in pairs), max(t for _, t in pairs)
    return 3 * (longest[0] - 1) + (longest[1] - 1) + 9 * len(pairs)


def extended_ops(piece, n, vol, gen_nnz, pairs):
    """f32 operations of one piece of the extended measurement, counted
    from ops/measure.py and ops/smear.py (matrix products at mmul_ops, the
    elementwise terms beside them; APE's eigendecomposition and the
    principal root are not counted, so its bound is low).  gen_nnz: the
    nonzero entries of the Fmunu generators together."""
    m = mmul_ops(n)
    if piece == "join":
        return 4 * vol * codec_ops(n)
    if piece == "fmunu":
        return 6 * vol * (3 * m + 8 * gen_nnz)
    if piece == "wilson":
        return vol * wilson_line_products(pairs) * m
    if piece == "qtop":
        # 6 clovers of 4 leaves of 3 products, 3 adds, (C - C^+)/8 and the
        # trace; 3 trace products of 4 n^2 operations
        return vol * (6 * (12 * m + 6 * 2 * n * n + 4 * n * n) + 12 * n * n)
    if piece == "ape_step":
        # per direction: 6 staples of 2 products, X = a U + b S, X^+ X,
        # V diag V^+, X (X^+ X)^(-1/2), det
        return 4 * vol * (15 * m + 8 * n * n + 14 * 6)
    raise ValueError(piece)


def extended_phase(dev, smi, counters):
    """Phase 8.  Returns the launches of its main-path run (c)."""
    from qcdgpu_tpu_torch import SimConfig, Simulation, cli
    from qcdgpu_tpu_torch.models import BetaScan
    from qcdgpu_tpu_torch.ops import measure as tmeas
    from qcdgpu_tpu_torch.ops import rng, smear
    from qcdgpu_tpu_torch.ops import sun
    from qcdgpu_tpu_torch.ops.cuda import engine
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate
    from qcdgpu_tpu_torch.utils.stats import analyze_series, creutz_ratio

    def maxd(a, b):
        return float(torch.max(torch.abs(a.cpu() - b.cpu())))

    last = [time.perf_counter()]

    def mark(label):
        now = time.perf_counter()
        print(f"-- {label}: {now - last[0]:.1f} s")
        last[0] = now

    # (a) the card against the CPU on a hot 8^4 field, every option
    for n in GROUPS:
        cfg = extended_cfg(SimConfig(group=n, dims=STREAM_SMALL_RUN, seed=1))
        us = engine.packed_hot_start(cfg, rng.make_base_key(1), dev)
        us_cpu = tuple(a.cpu() for a in us)
        dims = tuple(cfg.dims)
        v_gpu = engine.measure_all_split(us, dims, cfg)
        v_cpu = engine.measure_all_split(us_cpu, dims, cfg)
        d_ext = maxd(v_gpu[6:], v_cpu[6:])
        s_gpu = smear.ape_smear(engine.join_links(us, dims), 0.5, 2)
        s_cpu = smear.ape_smear(engine.join_links(us_cpu, dims), 0.5, 2)
        d_smear = maxd(s_gpu, s_cpu)
        msg = (f"(a) SU({n}) {dims} hot, every option (qtop_smear 2): card "
               f"against CPU, {v_gpu.numel() - 6} extended columns |d| "
               f"{d_ext:.2e} (<= {EXT_TOL:.0e}); smeared links |d| "
               f"{d_smear:.2e} (<= {SMEAR_TOL:.0e})")
        print(msg)
        require(bool(torch.isfinite(v_gpu).all()) and d_ext <= EXT_TOL
                and d_smear <= SMEAR_TOL, msg)
        del us, us_cpu, s_gpu, s_cpu
    mark("(a)")

    # (b) exact backgrounds at 32^4 on the card
    cold = extended_cfg(SimConfig(group=3, dims=BIG), smear=0).replace(
        fmunu_index1=1, fmunu_index2=2)
    u = engine.join_links(engine.packed_cold_start(cold, dev), BIG)
    ext = tmeas.measure_extended(u, cold)
    n_f = 12 * len(tmeas.cfg_fmunu_indices(cold))
    f_max = float(ext[:n_f].abs().max())
    w_max = float((ext[n_f:-1] - 1.0).abs().max())
    q0 = float(ext[-1])
    msg = (f"(b) cold SU(3) {BIG}: max |F| {f_max:.1e}, max |W - 1| "
           f"{w_max:.1e}, |Q| {abs(q0):.1e} (<= {EXACT_TOL:.0e})")
    print(msg)
    require(max(f_max, w_max, abs(q0)) <= EXACT_TOL, msg)
    flux, q_exact = abelian_two_flux(BIG)
    u = torch.from_numpy(flux).to(dev)
    del flux
    q = float(tmeas.topological_charge(u))
    us2 = smear.ape_smear(u, 0.5, 2)
    d_fix = maxd(us2, u)
    q2 = float(tmeas.topological_charge(us2))
    rel, rel2 = abs(q - q_exact) / abs(q_exact), abs(q2 - q) / abs(q)
    msg = (f"(b) SU(3) {BIG} abelian two-flux: Q_L {q:.4f}, exact "
           f"V sin B1 sin B2 / 2 pi^2 = {q_exact:.4f}, rel |d| {rel:.1e} "
           f"(<= 1e-4); 2 APE steps move the links by {d_fix:.1e} (<= "
           f"{SMEAR_TOL:.0e}) and Q_L by {rel2:.1e} relative (<= 1e-3)")
    print(msg)
    require(rel <= 1e-4 and d_fix <= SMEAR_TOL and rel2 <= 1e-3, msg)
    del u, us2
    mark("(b)")

    # (c) the main path at full width: the bench's hw configuration with
    # every extended option
    bench = SimConfig(group=3, beta=6.0, dims=BIG, reunit_every=10,
                      start="cold", seed=0, rng_mode="hw")
    cfg = extended_cfg(bench)

    def main_run(c, label):
        """Simulation(c): warmup(), then thermalize(THERM) + run(RUN, 5)
        with the launch counters zeroed; -> (sim, series, launches)."""
        for cnt in counters:
            for k in cnt:
                cnt[k] = 0
        sim = Simulation(c)
        sim.warmup()
        for cnt in counters:
            for k in cnt:
                cnt[k] = 0
        t0 = time.perf_counter()
        sim.thermalize(THERM)
        obs = sim.run(RUN, 5)
        sim.sync()
        wall = time.perf_counter() - t0
        launches = {k: v for cnt in counters for k, v in cnt.items() if v}
        # each launch once per shard on a mesh, of the shard forms
        k = int(np.prod(c.mesh))
        loc = "_local" if k > 1 else ""
        expect = {cupdate.instance_name("heatbath", 3, shard=k > 1,
                                        philox=True): 8 * (THERM + RUN) * k,
                  "reunit_su3": 8 * (THERM + RUN) // 10 * k,
                  f"plane_sums{loc}_su3": RUN // 5 * k,
                  f"polyakov_sums{loc}_su3": RUN // 5 * k}
        require(launches == expect,
                f"{label}: launches {launches}, expected {expect}")
        names = list(sim.obs_names)
        w11 = obs[:, names.index("wloop_1x1")]
        plq_t = obs[:, names.index("plq_t")]
        d_w = float(np.abs(w11 - plq_t).max())
        last = np.array(list(sim.measure().values()), np.float32)
        print(f"(c) {label}: thermalize({THERM}) + run({RUN}, 5) {wall:.2f} "
              f"s, {obs.shape[0]} rows of {obs.shape[1]}; launches "
              f"{launches}; max |W(1,1) - plq_t| {d_w:.1e} (<= 1e-5); "
              f"measure() == last row {np.array_equal(last, obs[-1])}; "
              f"plq {obs[-1, 0]:.6f} q_top {obs[-1, -1]:+.4f}  [{smi}]")
        require(np.isfinite(obs).all() and d_w <= 1e-5
                and np.array_equal(last, obs[-1]),
                f"{label}: series {obs}")
        return sim, obs, launches

    sim, obs, launches = main_run(cfg, "bench hw + every extended option")
    dims = BIG
    us = sim.us
    indices = tmeas.cfg_fmunu_indices(cfg)
    gen_nnz = sum(int(np.count_nonzero(tmeas.generator(3, a)))
                  for a in indices)
    u = engine.join_links(us, dims)
    us2 = smear.ape_smear(u, 0.5, 2)
    defect = max(float(sun.unitarity_defect(us2[mu])) for mu in range(4))
    print(f"(c) the smeared field's unitarity defect {defect:.2e} (<= 1e-5)")
    require(defect <= 1e-5, f"smeared unitarity defect {defect}")
    del us2
    nbytes = sum(a.numel() * a.element_size() for a in us)
    vol = int(np.prod(dims))
    pieces = (
        ("join", lambda: engine.join_links(us, dims)),
        ("fmunu", lambda: tmeas.fmunu_means(u, indices)),
        ("wilson", lambda: tmeas.wilson_loop_means(u, WILSON_PAIRS)),
        ("qtop", lambda: tmeas.topological_charge(u)),
        ("ape_step", lambda: smear.ape_smear_step(u, 0.5)),
        ("measurement", lambda: engine.measure_all_split(us, dims, cfg)))
    from torch.profiler import ProfilerActivity, profile

    for name, fn in pieces:
        # the warm-up call gives the peak memory
        sync()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        sync()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ms = event_ms(fn, 3, warm=False)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        ev = device_events(prof)
        n_launch = sum(c for _, c in ev.values())
        busy = sum(t for t, _ in ev.values())
        if name == "measurement":
            tail = "(the standard six by K3/K4, then the extras, 2 APE steps)"
        else:
            ops = extended_ops(name, 3, vol, gen_nnz, WILSON_PAIRS)
            b_ms, b_by = bound(nbytes, ops, 0)
            tail = (f"bound {b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB "
                    f"of packed links, {ops:.3e} f32 operations)")
        print(f"(c) extended {name} at SU(3) {dims}: {ms:.3f} ms "
              f"(CUDA events, mean of 3), device busy "
              + (f"{busy:.3f} ms, {n_launch} launches" if ev else
                 "not measured (empty trace)")
              + f", peak {peak:.3f} GiB above the state; {tail}  [{smi}]")
    del u
    print(f"(c) max_memory_allocated over the phase so far "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    mark("(c) the run and the pieces' times")

    # ms/sweep of the bench hw configuration with the extras measured
    # every 5 sweeps, beside the same without extras (measured every 5)
    for label, c in (("with every extended option", cfg),
                     ("standard six only", bench)):
        s = Simulation(c)
        s.warmup()
        s.sync()
        t0 = time.perf_counter()
        s.run(20, 5)
        s.sync()
        print(f"(c) bench hw {label}, run(20, 5): "
              f"{(time.perf_counter() - t0) / 20 * 1e3:.3f} ms/sweep  "
              f"[{smi}]")
        del s

    # the same run on mesh (2,2,1,1) on one card: bit-identical
    obs_m = main_run(cfg.replace(mesh=MESH), f"mesh {MESH}")[1]
    same = np.array_equal(obs_m, obs)
    print(f"(c) mesh {MESH}: the series (every extended column) "
          f"bit-identical to the unsharded run's {same}")
    require(same, f"mesh {MESH} extended series differs")
    mark("(c) ms/sweep and the mesh run")

    # (e) meas_dtype="double": bit-identical to "same"
    obs_d = main_run(cfg.replace(meas_dtype="double"),
                     'meas_dtype="double"')[1]
    same = np.array_equal(obs_d, obs)
    print(f'(e) meas_dtype="double": the series bit-identical to "same"\'s '
          f"{same}")
    require(same, 'meas_dtype="double" series differs')
    mark("(e)")
    del sim, us

    # (d) the physics gate: docs/validation/wilson_su3.json's run
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           WILSON_RECORD)) as f:
        rec = json.load(f)
    gcfg = SimConfig(group=3, dims=GATE_DIMS, beta=6.0, n_or=1, seed=17,
                     wilson_loops=WILSON_PAIRS, sweeps_therm=300, sweeps=500,
                     meas_every=2)
    gsim = Simulation(gcfg)
    gsim.warmup()
    t0 = time.perf_counter()
    gsim.thermalize()
    gobs = gsim.run()
    gsim.sync()
    names = list(gsim.obs_names)
    loops, worst = {}, 0.0
    for r, t in WILSON_PAIRS:
        k = f"wloop_{r}x{t}"
        st = analyze_series(gobs[:, names.index(k)])
        loops[k] = (st.mean, st.err)
        m_rec, e_rec = rec["wilson_loops"][k]
        z = abs(st.mean - m_rec) / np.hypot(st.err, e_rec)
        worst = max(worst, z)
        print(f"(d) {k}: {st.mean:.6f} +- {st.err:.6f}; record "
              f"{m_rec:.6f} +- {e_rec:.6f}; {z:.2f} sigma")
    chi, chi_err = creutz_ratio(loops, 2, 2)
    m_rec, e_rec = rec["creutz_ratios"]["chi_2x2"]
    z = abs(chi - m_rec) / np.hypot(chi_err, e_rec)
    worst = max(worst, z)
    print(f"(d) chi(2,2): {chi:.5f} +- {chi_err:.5f}; record {m_rec:.5f} "
          f"+- {e_rec:.5f}; {z:.2f} sigma; worst {worst:.2f} sigma (<= "
          f"{GATE_SIGMAS}); {gobs.shape[0]} measurements, "
          f"{time.perf_counter() - t0:.1f} s  [{smi}]")
    require(worst <= GATE_SIGMAS, f"Wilson-loop gate: {worst} sigma")
    del gsim
    mark("(d)")

    # (f) the scan: 3 chains at 8^4, each chain's rows its Simulation's
    scfg = SimConfig(group=3, dims=STREAM_SMALL_RUN, start="hot", seed=2,
                     wilson_loops=((1, 1), (2, 2)), get_qtop=True)
    scan = BetaScan(scfg, CHAIN_BETAS[3])
    scan.thermalize(2)
    sobs = scan.run(4, 1)
    same = True
    for c, beta in enumerate(scan.betas):
        s = Simulation(scfg.replace(seed=scfg.seed + 1000 * c,
                                    beta=float(beta)))
        s.thermalize(2)
        same = same and np.array_equal(sobs[c], s.run(4, 1))
    print(f"(f) BetaScan of {len(scan.betas)} chains at {STREAM_SMALL_RUN} "
          f"with wilson_loops and get_qtop: each chain's rows bit-identical "
          f"to its Simulation's {same}")
    require(same and np.isfinite(sobs).all(), "extended scan differs")
    del scan
    mark("(f)")

    # (g) the command line: run, resume, against an uninterrupted run
    args = ["--dims", str(STREAM_SMALL_RUN[0]), "--wilson-loops",
            "1x1,1x2,2x1,2x2", "--get-qtop", "--qtop-smear", "1",
            "--start", "hot", "--seed", "3", "--therm", "2",
            "--ckpt-every", "2"]
    with tempfile.TemporaryDirectory() as tmp:
        a, b, c = (os.path.join(tmp, k) for k in "abc")
        with open(os.devnull, "w") as quiet:
            stdout, sys.stdout = sys.stdout, quiet
            try:
                cli.main(["run", *args, "--sweeps", "4", "--out", a])
                cli.main(["resume", os.path.join(a, "state.npz"),
                          "--sweeps", "4", "--out", b])
                cli.main(["run", *args, "--sweeps", "8", "--out", c])
            finally:
                sys.stdout = stdout
        with open(os.path.join(b, "results.json")) as f:
            rec_b = json.load(f)
        with open(os.path.join(c, "results.json")) as f:
            rec_c = json.load(f)
    same = rec_b["series"] == rec_c["series"]
    chis = sorted(rec_b.get("derived", {}))
    print(f"(g) CLI run 2 + 4 sweeps, resume 4: series bit-identical to an "
          f"uninterrupted 2 + 8 run {same}; Creutz ratios {chis}")
    require(same and chis == ["chi_1x1", "chi_1x2", "chi_2x1", "chi_2x2"]
            and "q_top" in rec_b["series"], "CLI extended run + resume")
    mark("(g)")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the dense engine (dense.py; no kernel of ours on its path)
# ---------------------------------------------------------------------------

DENSE_TOL = {"complex64": 2e-5, "complex128": 1e-10}
DENSE_THERM, DENSE_RUN = 5, 5


def dense_stage_bytes(n, vol, itemsize):
    """The least bytes of one dense stage: the whole field read once (the
    staples need every direction) and the updated direction written once."""
    return (4 + 1) * n * n * vol * itemsize


def dense_phase(dev, smi, counters):
    """Phase 9: (a) one dense stage per kind, card against CPU; (b) the
    full-width main path (Simulation(cfg) at SU(3) 32^4 on the dense
    engine): times, launches, memory, idle share; (c) validate config 6
    and the complex128 physics gates; (d) exact resume; (e) a 3-chain
    stream scan, each chain its Simulation; (f) the dense engine on a
    mesh (dense_mesh_phase)."""
    from qcdgpu_tpu_torch import SimConfig, Simulation, dense, validate
    from qcdgpu_tpu_torch.models import BetaScan
    from qcdgpu_tpu_torch.ops import prng_streams as ps
    from qcdgpu_tpu_torch.ops import rng
    from qcdgpu_tpu_torch.ops.lattice import parity_mask, site_index
    from qcdgpu_tpu_torch.ops.samplers import stage_uniform_count, update_links
    from qcdgpu_tpu_torch.ops.staples import staple_sum

    last = [time.perf_counter()]

    def mark(label):
        now = time.perf_counter()
        print(f"-- {label}: {now - last[0]:.1f} s")
        last[0] = now

    # (a) one stage of each kind, SU(3)/SU(2) x complex64/complex128 x
    # threefry/xor128, on the card and on the CPU from the same field
    dims = STREAM_SMALL_RUN
    cpu = torch.device("cpu")
    for n in GROUPS:
        for dt in ("complex64", "complex128"):
            cfg = SimConfig(group=n, dims=dims, dtype=dt, seed=1)
            u_gpu = dense.hot_start(cfg, rng.make_base_key(1), dev)
            u_cpu = u_gpu.cpu()
            worst = 0.0
            for src in ("threefry", "xor128"):
                for kind in ("heatbath", "overrelax", "metropolis"):
                    mu, parity = 2, 1
                    key2 = rng.stage_key(rng.make_base_key(1), 0, 7)
                    out = {}
                    for tag, d, u in (("card", dev, u_gpu),
                                      ("cpu", cpu, u_cpu)):
                        uu = None
                        if src != "threefry" and kind != "overrelax":
                            st = ps.make_stream_state(src, 5, dims, d)
                            uu, st = ps.stream_draw(
                                src, st, stage_uniform_count(n, kind))
                            uu = ps.open01(uu)
                            out[tag + "_words"] = st["x"].cpu()
                        new = update_links(u[mu], staple_sum(u, mu), kind,
                                           BETA_RUN[n], key2,
                                           site_index(dims, d),
                                           uniforms=uu)
                        out[tag] = torch.where(
                            parity_mask(dims, parity, d), new, u[mu]).cpu()
                    dlt = float(torch.max(torch.abs(out["card"] - out["cpu"])))
                    same_words = ("card_words" not in out or torch.equal(
                        out["card_words"], out["cpu_words"]))
                    require(dlt <= DENSE_TOL[dt] and same_words,
                            f"dense {kind} SU({n}) {dt} {src}: card vs CPU "
                            f"|d| {dlt}, words equal {same_words}")
                    worst = max(worst, dlt)
            print(f"(a) SU({n}) {dt} {dims}: heat-bath, overrelaxation, "
                  f"Metropolis, threefry and xor128 (words bit-identical): "
                  f"card against CPU max |d| {worst:.2e} (<= "
                  f"{DENSE_TOL[dt]:.0e})")
            del u_gpu, u_cpu
    # the card's f32 sqrt and 1/sqrt (ops/samplers.py _sqrt, _rsqrt) are
    # correctly rounded: the roots the CPU takes through f64, bit for bit
    from qcdgpu_tpu_torch.ops import samplers
    x = torch.rand(1 << 22, generator=torch.Generator().manual_seed(9)) \
        .to(dev)
    x = torch.cat([x, x * 1e-30, x * 1e30, torch.tensor(
        [0.0, 1.0, 2.0, 3.0, float(np.finfo(np.float32).tiny)],
        device=dev)])
    want = torch.sqrt(x.double()).float()
    bad = [int((samplers._sqrt(x) != want).sum()),
           int((samplers._rsqrt(x[x > 0])
                != (1.0 / want[x > 0].double()).float()).sum())]
    print(f"(a) the card's f32 sqrt and 1/sqrt on {x.numel()} values: "
          f"{bad[0]} and {bad[1]} differ from the correctly rounded ones")
    require(bad == [0, 0], f"the card's f32 sqrt is not correctly rounded: "
            f"{bad}")
    mark("(a)")

    # (b) the full-width main path: Simulation(cfg), no device argument
    from torch.profiler import ProfilerActivity, profile

    def profiled(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        ev = device_events(prof)
        if not ev:
            return wall, None, None, {}
        return (wall, sum(t for t, _ in ev.values()),
                sum(c for _, c in ev.values()), ev)

    results = {}
    base = SimConfig(group=3, dims=BIG, beta=6.0, start="cold",
                     reunit_every=10, rng_mode="threefry", engine="xla")
    mains = (("complex128", base.replace(dtype="complex128"),
              DENSE_THERM, DENSE_RUN),
             ("complex64 meas_dtype=double",
              base.replace(meas_dtype="double"), DENSE_THERM, DENSE_RUN),
             ("complex64 prngcl:ranlux3",
              base.replace(rng_mode="prngcl:ranlux3"), 2, 2))
    for label, cfg, n_therm, n_run in mains:
        for cnt in counters:
            for k in cnt:
                cnt[k] = 0
        sync()
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        sim = Simulation(cfg)
        require(sim.engine == "xla" and sim.device == dev,
                f"{label}: engine {sim.engine} on {sim.device}")
        t0 = time.perf_counter()
        sim.warmup()
        t_warm = time.perf_counter() - t0
        sync()
        t0 = time.perf_counter()
        sim.thermalize(n_therm)
        sim.sync()
        t_therm = (time.perf_counter() - t0) * 1e3 / n_therm
        t0 = time.perf_counter()
        obs = sim.run(n_run, 1)
        t_run = (time.perf_counter() - t0) * 1e3 / n_run
        peak = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
        ours = {k: v for cnt in counters for k, v in cnt.items() if v}
        require(not ours, f"{label}: the dense path launched {ours}")
        if label == "complex128":
            # (f) holds the same run on a mesh to these links and series
            flat = (cfg, sim.u, obs)
        # one sweep alone and one measured sweep, on the host clock, then
        # under the profiler (device busy time and launches)
        w1, busy1, n1, ev1 = profiled(lambda: sim.thermalize(1))
        w2, busy2, n2, _ = profiled(lambda: sim.run(1, 1))
        top = sorted(ev1.items(), key=lambda kv: -kv[1][0])[:4]
        idle = None if busy1 is None else 1.0 - busy1 / w1
        state_gib = sim.us.numel() * sim.us.element_size() / 2 ** 30
        itemsize = sim.us.element_size()
        b_ms = 8 * dense_stage_bytes(3, int(np.prod(BIG)), itemsize) \
            / HBM_BYTES_PER_S * 1e3
        plq = obs[:, 0]
        require(np.isfinite(obs).all() and 0.45 < plq[-1] < 0.9
                and sim.unitarity_defect() < 1e-4,
                f"{label}: series {obs}")
        results[label] = dict(
            ms_sweep=t_therm, ms_sweep_measured=t_run, launches_sweep=n1,
            launches_measured_sweep=n2, device_busy_ms=busy1, idle=idle,
            peak_gib=peak, state_gib=state_gib, bound_ms=b_ms,
            plq=float(plq[-1]))
        print(f"(b) {label} SU(3) {BIG} HB cold, engine {sim.engine}: "
              f"warmup {t_warm:.1f} s; {t_therm:.1f} ms/sweep "
              f"(thermalize({n_therm})), {t_run:.1f} ms/sweep measured "
              f"(run({n_run}, 1)); one sweep: {w1:.1f} ms host, device busy "
              + (f"{busy1:.1f} ms, {n1} launches, idle share {idle:.3f}"
                 if busy1 is not None else "not measured (empty trace)")
              + "; one measured sweep: "
              + (f"{w2:.1f} ms host, device busy {busy2:.1f} ms, {n2} "
                 "launches" if busy2 is not None else "not measured")
              + f"; peak {peak:.3f} GiB above the start ({state_gib:.3f} "
              f"GiB of links); bound {b_ms:.3f} ms/sweep by bytes (8 "
              f"stages, each the field read and one direction written); "
              f"plq {plq[-1]:.6f}; no kernel of ours launched  [{smi}]")
        for name, (ms, calls) in top:
            print(f"    one sweep's device time: {ms:.2f} ms in {calls} "
                  f"launches of {name[:90]}")
        del sim
        mark(f"(b) {label}")

    # (c) validate config 6 and the complex128 physics gates
    r = validate.check_engines()
    print(f"(c) {r['name']}: {r['measured']} ({r['expected']}); pass "
          f"{r['pass']}")
    require(r["pass"], f"config 6: {r}")
    for check in (validate.check_su3, validate.check_su2):
        r = check(quick=True, engine="xla", dtype="complex128")
        print(f"(c) {r['name']}: measured {r['measured']} +- "
              f"{r['err']:.7f}; literature {r['expected']} within "
              f"{r['tolerance']:.2e}; pass {r['pass']}")
        require(r["pass"], f"{r['name']}: {r}")
    mark("(c)")

    # (d) resume: a dense stream run at 8^4 saved, loaded and continued
    cfg = SimConfig(group=3, dims=STREAM_SMALL_RUN, beta=6.0, start="hot",
                    rng_mode="prngcl:ranlux3", engine="xla",
                    dtype="complex128", seed=3)
    a = Simulation(cfg)
    a.thermalize(2)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        a.save(path)
        b = Simulation.load(path)
    oa, ob = a.run(3, 1), b.run(3, 1)
    same = (np.array_equal(oa, ob) and torch.equal(a.u, b.u)
            and all(np.array_equal(v, b.stream_state[k])
                    for k, v in a.stream_state.items()))
    print(f"(d) {cfg.rng_mode} complex128 {cfg.dims}: saved after 2 sweeps, "
          f"loaded, 3 more: series, links and streams bit-identical {same}")
    require(same, "dense resume differs")
    mark("(d)")

    # (e) a 3-chain dense prngcl:xor128 scan, each chain its Simulation
    cfg = SimConfig(group=3, dims=STREAM_SMALL_RUN, start="hot",
                    rng_mode="prngcl:xor128", seed=4)
    betas = CHAIN_BETAS[3]
    scan = BetaScan(cfg, betas)
    require(scan.engine == "xla", f"scan engine {scan.engine}")
    obs = scan.thermalize(2).run(2, 1)
    u = scan.u
    for c, beta in enumerate(betas):
        sim = Simulation(cfg.replace(seed=cfg.seed + 1000 * c,
                                     beta=float(np.float32(beta)),
                                     engine="xla"))
        sim.thermalize(2)
        o = sim.run(2, 1)
        require(torch.equal(sim.u, u[c]) and np.array_equal(o, obs[c]),
                f"scan chain {c} differs from its Simulation")
    print(f"(e) {len(betas)}-chain {cfg.rng_mode} scan {cfg.dims}: every "
          "chain's links and series bit-identical to its dense Simulation")
    # and a complex128 threefry scan
    cfg = cfg.replace(rng_mode="threefry", dtype="complex128")
    scan = BetaScan(cfg, betas)
    obs = scan.thermalize(2).run(2, 1)
    u = scan.u
    for c, beta in enumerate(betas):
        sim = Simulation(cfg.replace(seed=cfg.seed + 1000 * c,
                                     beta=float(np.float32(beta))))
        sim.thermalize(2)
        o = sim.run(2, 1)
        require(torch.equal(sim.u, u[c]) and np.array_equal(o, obs[c]),
                f"complex128 scan chain {c} differs from its Simulation")
    print(f"(e) {len(betas)}-chain threefry complex128 scan {cfg.dims}: "
          "every chain bit-identical to its dense Simulation")
    mark("(e)")
    results.update(dense_mesh_phase(dev, smi, counters, flat, profiled, mark))
    return results


# the mesh of phase 9 (f)'s full-width run, and of --cards N's dense run
DENSE_MESH = (1, 1, 2, 2)
HALO_SPAN = "dense halo refresh"


def traced_halo_copies(sim):
    """One sweep of the dense mesh run ``sim`` under torch.profiler, each
    halo refresh (dense_sharded.refresh) in a record_function span.
    Returns (spans, {device event name: count}) of the device events whose
    launching runtime call (joined by its correlation id) began inside a
    span."""
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)

    from qcdgpu_tpu_torch import dense_sharded as dsh

    real = dsh.refresh

    def refresh(plan, mu):
        with record_function(HALO_SPAN):
            real(plan, mu)

    dsh.refresh = refresh
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            sim.thermalize(1)
            sim.sync()
    finally:
        dsh.refresh = real
    events = trace_events(prof)
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("name") == HALO_SPAN
             and e.get("cat") != "gpu_user_annotation"]
    inside = {e["args"]["correlation"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})
              and any(a <= e["ts"] <= b for a, b in spans)}
    copies = {}
    for e in events:
        if (e.get("cat") in DEVICE_CATS
                and e.get("args", {}).get("correlation") in inside):
            copies[e["name"]] = copies.get(e["name"], 0) + 1
    return len(spans), copies


def dense_mesh_phase(dev, smi, counters, flat, profiled, mark):
    """Phase 9 (f): the dense engine on a mesh, every shard on the card.
    The full-width run of (b)'s complex128 configuration on DENSE_MESH
    (``flat``: (b)'s configuration, links and series after the same
    sweeps): links torch.equal, series within 1e-5, ms/sweep, launches,
    device busy time, idle share, peak memory and halo copies; then at 8^4
    the dense configurations on a mesh, 2 sweeps each against its
    unsharded dense run bit for bit; a 3-chain stream scan on a mesh and
    in 3 chain blocks, each chain its mesh Simulation; the CLI run on one
    mesh resumed on another; validate config 5 on the one card.  None of
    our kernels may launch."""
    from qcdgpu_tpu_torch import SimConfig, Simulation, cli, validate
    from qcdgpu_tpu_torch.dense_sharded import halo_copies_per_stage
    from qcdgpu_tpu_torch.models import BetaScan
    from qcdgpu_tpu_torch.utils.checkpoint import load_state

    for cnt in counters:
        for k in cnt:
            cnt[k] = 0
    cfg, u_flat, obs_flat = flat
    cfg = cfg.replace(mesh=DENSE_MESH)
    sync()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    sim = Simulation(cfg)
    grid = sim._run.grid
    require(sim.engine == "xla" and len(grid) == 4
            and set(grid.devices) == {dev},
            f"(f) engine {sim.engine}, shards on {grid.devices}")
    sim.warmup()
    sync()
    t0 = time.perf_counter()
    sim.thermalize(DENSE_THERM)
    sim.sync()
    t_therm = (time.perf_counter() - t0) * 1e3 / DENSE_THERM
    t0 = time.perf_counter()
    obs = sim.run(DENSE_RUN, 1)
    t_run = (time.perf_counter() - t0) * 1e3 / DENSE_RUN
    peak = (torch.cuda.max_memory_allocated() - mem0) / 2 ** 30
    same = torch.equal(sim.u, u_flat)
    dobs = float(np.max(np.abs(obs - obs_flat)))
    print(f"(f) complex128 SU(3) {cfg.dims} HB cold on mesh {cfg.mesh}, "
          f"{len(grid)} shards on {dev}, thermalize({DENSE_THERM}) + "
          f"run({DENSE_RUN}, 1): links torch.equal to (b)'s unsharded run "
          f"{same}, series max |d| {dobs:.2e} (< 1e-5)")
    require(same and dobs < 1e-5, "(f) the mesh run differs from (b)'s")
    del u_flat
    w1, busy1, n1, ev1 = profiled(lambda: sim.thermalize(1))
    w2, busy2, n2, _ = profiled(lambda: sim.run(1, 1))
    idle = None if busy1 is None else 1.0 - busy1 / w1
    stages = 8 * (1 + cfg.n_or)
    planned = halo_copies_per_stage(grid) * stages
    n_spans, halo_ev = traced_halo_copies(sim)
    halos = sum(halo_ev.values())
    copies = sum(c for name, (_, c) in ev1.items()
                 if "opy" in name or "Memcpy" in name)
    print(f"(f) mesh {cfg.mesh}: {t_therm:.1f} ms/sweep (thermalize("
          f"{DENSE_THERM})), {t_run:.1f} ms/sweep measured (run({DENSE_RUN}"
          f", 1)); one sweep: {w1:.1f} ms host, device busy "
          + (f"{busy1:.1f} ms, {n1} launches, idle share {idle:.3f}"
             if busy1 is not None else "not measured (empty trace)")
          + "; one measured sweep: "
          + (f"{w2:.1f} ms host, device busy {busy2:.1f} ms, {n2} launches"
             if busy2 is not None else "not measured")
          + f"; {copies} device copy events in the trace; peak "
          f"{peak:.3f} GiB above the start  [{smi}]")
    print(f"(f) halo refresh in one traced sweep: {halos} device events "
          f"launched inside the {n_spans} refreshes ({planned} slab copies "
          f"by the plan): "
          + ("; ".join(f"{c} x {name[:70]}" for name, c in sorted(
              halo_ev.items(), key=lambda kv: -kv[1]))
             or "none in the trace"))
    require(n_spans == stages, f"(f) {n_spans} halo refreshes in a sweep "
            f"of {stages} stages")
    for name, (ms, calls) in sorted(ev1.items(), key=lambda kv: -kv[1][0]
                                    )[:4]:
        print(f"    one mesh sweep's device time: {ms:.2f} ms in {calls} "
              f"launches of {name[:90]}")
    results = {"mesh": dict(ms_sweep=t_therm, ms_sweep_measured=t_run,
                            launches_sweep=n1, device_busy_ms=busy1,
                            idle=idle, peak_gib=peak, halo_copies=halos,
                            halo_copies_planned=planned)}
    del sim
    mark("(f) full width")

    # the dense engine on each kind of mesh, at 8^4: 2 sweeps from a
    # hot start against the unsharded dense run of the same configuration
    small = SimConfig(group=3, dims=STREAM_SMALL_RUN, beta=6.0, start="hot",
                      seed=5, reunit_every=2)
    cases = (("Z/T mesh, engine auto", small, (1, 1, 1, 2)),
             ("engine xla complex64", small.replace(engine="xla"),
              (2, 2, 1, 1)),
             ("prngcl:ranlux3", small.replace(engine="xla",
                                              rng_mode="prngcl:ranlux3"),
              (1, 2, 1, 1)),
             ("prngcl:mrg32k3a", small.replace(engine="xla",
                                               rng_mode="prngcl:mrg32k3a"),
              (1, 2, 1, 1)),
             ("meas_dtype double", small.replace(engine="xla",
                                                 meas_dtype="double"),
              (1, 1, 2, 2)),
             ("complex128 SU(2) Metropolis, acc", small.replace(
                 group=2, beta=2.4, dtype="complex128",
                 algorithm="metropolis", track_acceptance=True, n_or=1),
              (2, 1, 2, 1)),
             ("extended observables", extended_cfg(small, smear=1),
              (2, 1, 1, 2)))
    for label, c, mesh in cases:
        out = []
        for m in (mesh, (1, 1, 1, 1)):
            # the unsharded run pinned to the dense engine (a complex64
            # run without a Z/T split would resolve to the packed one)
            s = Simulation(c.replace(mesh=m) if m == mesh
                           else c.replace(mesh=m, engine="xla"))
            require(s.engine == "xla" and len(s._run.grid) == np.prod(m),
                    f"{label}: engine {s.engine} on {len(s._run.grid)}")
            o = s.run(2, 1)
            out.append((s.u, o, s.stream_state))
            del s
        (u1, o1, r1), (u0, o0, r0) = out
        same = torch.equal(u1, u0) and (r0 is None or all(
            np.array_equal(r1[k], v) for k, v in r0.items()))
        d_std = float(np.max(np.abs(o1[:, :6] - o0[:, :6])))
        same_ext = np.array_equal(o1[:, 6:], o0[:, 6:])
        print(f"(f) {label} {c.dims} on {mesh}: links"
              + (" and streams" if r0 is not None else "")
              + f" bit-identical to unsharded {same}; standard columns "
              f"max |d| {d_std:.2e}; the other {o1.shape[1] - 6} columns "
              f"equal {same_ext}")
        require(same and d_std < 1e-5 and same_ext, f"(f) {label} differs")

    # a 3-chain stream scan on a mesh, in one block and in 3
    cfg = small.replace(rng_mode="prngcl:xor128", mesh=(1, 1, 2, 1))
    betas = CHAIN_BETAS[3]
    sims = []
    for c, beta in enumerate(betas):
        s = Simulation(cfg.replace(seed=cfg.seed + 1000 * c,
                                   beta=float(np.float32(beta))))
        sims.append((s.run(2, 1), s.u, s.stream_state))
        del s
    for blocks in (1, 3):
        scan = BetaScan(cfg, betas, blocks)
        require(scan.engine == "xla" and len(scan._run.grid) == blocks,
                f"scan engine {scan.engine}")
        obs = scan.run(2, 1)
        u, rst = scan.u, scan.stream_state
        for c, (o, uc, rc) in enumerate(sims):
            require(np.array_equal(o, obs[c]) and torch.equal(uc, u[c])
                    and all(np.array_equal(
                        rst[k][c] if np.ndim(v) >= 4 else rst[k], v)
                        for k, v in rc.items()),
                    f"(f) scan chain {c} in {blocks} blocks differs")
        del scan
    print(f"(f) {len(betas)}-chain {cfg.rng_mode} scan {cfg.dims} on "
          f"{cfg.mesh}, one chain block and 3: every chain's links, series "
          "and streams bit-identical to its mesh Simulation")

    # the command line: run on one mesh with checkpoints, resume on another
    with tempfile.TemporaryDirectory() as tmp:
        common = ["--group", "3", "--dims", "8", "--dtype", "complex128",
                  "--start", "hot", "--seed", "4", "--ckpt-every", "2",
                  "--therm", "1"]
        a, b, c = (os.path.join(tmp, x) for x in "abc")
        # the runs' own reports are not this script's output
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["run", *common, "--mesh", "1,1,2,2", "--sweeps", "2",
                      "--out", a])
            cli.main(["resume", os.path.join(a, "state.npz"), "--mesh",
                      "2,1,1,1", "--sweeps", "2", "--out", b])
            cli.main(["run", *common, "--sweeps", "4", "--out", c])
        recs, links = [], []
        for out in (b, c):
            with open(os.path.join(out, "results.json")) as f:
                recs.append(json.load(f))
            links.append(load_state(os.path.join(out, "state.npz"))[1])
    same = np.array_equal(links[0], links[1])
    dplq = float(np.max(np.abs(np.subtract(recs[0]["series"]["plq"],
                                           recs[1]["series"]["plq"]))))
    print(f"(f) CLI run --mesh 1,1,2,2 --dtype complex128 (1 + 2 sweeps), "
          f"resume --mesh 2,1,1,1 (2): links bit-identical to an "
          f"uninterrupted unsharded run {same}, plq series max |d| "
          f"{dplq:.1e}; records: engine {recs[0]['engine']}, mesh "
          f"{recs[0]['mesh']}")
    require(same and dplq < 1e-5 and recs[0]["engine"] == "xla"
            and recs[0]["mesh"] == [2, 1, 1, 1], "(f) CLI resume differs")

    # validate config 5 on the one card: the reference's fallback
    r = validate.check_multichip()
    print(f"(f) {r['name']}: {r['measured']} ({r['expected']}); pass "
          f"{r['pass']}")
    require(r["pass"] is True, f"config 5: {r}")
    ours = {k: v for cnt in counters for k, v in cnt.items() if v}
    require(not ours, f"(f) the dense mesh path launched {ours}")
    print("(f) no kernel of ours launched on the dense mesh path")
    mark("(f) 8^4, scan, CLI, config 5")
    return results


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--cards"]:
        return multicard(int(sys.argv[2]))
    from qcdgpu_tpu_torch import SimConfig, Simulation, cli, validate
    from qcdgpu_tpu_torch.ops import prng_streams as ps
    from qcdgpu_tpu_torch.ops import rng
    from qcdgpu_tpu_torch.ops.cuda import build, engine
    from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure
    from qcdgpu_tpu_torch.ops.cuda import reunit as creunit
    from qcdgpu_tpu_torch.ops.cuda import sharded
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate
    from qcdgpu_tpu_torch.models import BetaScan, baseline_config
    from qcdgpu_tpu_torch.models.ensemble import betas_tensor, keys_tensor
    from qcdgpu_tpu_torch.parallel.mesh import ShardGrid
    from qcdgpu_tpu_torch.utils.checkpoint import load_betascan

    dev = torch.device("cuda", 0)
    counters = (cupdate.LAUNCHES, creunit.LAUNCHES, cmeasure.LAUNCHES)
    k1_cases = [(n, kind, track) for n in GROUPS for kind in cupdate.KINDS
                for track in (False, True)
                if not (track and kind == "overrelax")]
    src = "qcdgpu_tpu_torch/csrc/"
    tpu = "qcdgpu_tpu/ops/pallas/"
    record = {}
    for n, kind, track in k1_cases:
        name = cupdate.instance_name(kind, n, track)
        record[name] = (name, "stage.cu", "update.py:460")
    for name in cupdate.STREAM_INSTANCES:
        fam = name.split("_")[3]
        # K1's stream branch: the draws of K7 (counter-free) or K8 (lag)
        record[name] = (name, f"stage_{fam}.cu", "prng_streams.py:" + (
            "767" if fam in ("ranlux", "ranmar") else "625"))
    for name in cupdate.PHILOX_INSTANCES:
        # K9: the hardware-PRNG branch of _stage_kernel, drawn from Philox
        record[name] = (name, "stage_philox.cu", "update.py:543")
    for name in cupdate.SHARD_INSTANCES:
        # K1a: the halo-padded shard form of _stage_kernel (_stage_call with
        # local_x / local_y > 0); its Philox twins K9's too
        fam = name.split("_")[3]
        record[name] = (name, "stage.cu" if fam in ("track", "shard")
                        else f"stage_{fam}.cu",
                        "update.py:543" if fam == "philox" else
                        "update.py:602")
    for name in cupdate.CHAIN_INSTANCES:
        # K1c: _stage_kernel vmapped over the chains (models/ensemble.py:
        # 125); its Philox instantiations K9's too
        record[name] = (name, "stage_chains.cu", "update.py:543"
                        if "_philox" in name else "update.py:460")
    for name in cupdate.CHAIN_SHARD_INSTANCES:
        # K1ac: the shard form of _stage_kernel vmapped over a chain block
        # (models/ensemble.py:96-131); its Philox instantiations K9's too
        record[name] = (name, "stage_chains_sharded.cu", "update.py:543"
                        if "_philox" in name else "update.py:602")
    for n in GROUPS:
        record[f"reunit_chains_su{n}"] = (f"reunit_chains_su{n}", "reunit.cu",
                                          "reunit.py:22")
        record[f"plane_sums_chains_su{n}"] = (f"plane_sums_chains_su{n}",
                                              "measure.cu", "measure.py:67")
        record[f"polyakov_sums_chains_su{n}"] = (
            f"polyakov_sums_chains_su{n}", "measure.cu", "measure.py:155")
    for n in GROUPS:
        # K5ac / K5bc: the sharded measurement bodies over a chain block
        record[f"plane_sums_local_chains_su{n}"] = (
            f"plane_sums_local_chains_su{n}", "measure.cu", "measure.py:269")
        record[f"polyakov_sums_local_chains_su{n}"] = (
            f"polyakov_sums_local_chains_su{n}", "measure.cu",
            "measure.py:349")
        record[f"plane_sums_local_su{n}"] = (f"plane_sums_local_su{n}",
                                             "measure.cu", "measure.py:269")
        record[f"polyakov_sums_local_su{n}"] = (
            f"polyakov_sums_local_su{n}", "measure.cu", "measure.py:349")
        record[f"reunit_su{n}"] = (f"reunit_su{n}", "reunit.cu",
                                   "reunit.py:22")
        record[f"plane_sums_su{n}"] = (f"plane_sums_su{n}", "measure.cu",
                                       "measure.py:67")
        record[f"polyakov_sums_su{n}"] = (f"polyakov_sums_su{n}",
                                          "measure.cu", "measure.py:155")
    for key, (name, source, replaces) in record.items():
        record[key] = {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": ("qcdgpu_tpu/ops/" if "prng" in replaces else tpu)
            + replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None, "device_ms": None}
    require(set(record) == {k for c in counters for k in c},
            "launch counters and kernel record disagree")

    with Phase("1 device"):
        smi = nvidia_smi_lines()[0]
        print("card:", smi)
        print("torch", torch.__version__, "cuda", torch.version.cuda,
              "device", torch.cuda.get_device_name(0),
              "count", torch.cuda.device_count())
        nvcc = subprocess.run([build.nvcc_path(), "--version"],
                              capture_output=True, text=True, check=True)
        print(nvcc.stdout.strip().splitlines()[-1])

    with Phase("2 build"):
        info = build.build()
        print(f"library {info['path'].name}: built={info['built']} "
              f"in {info['seconds']:.1f} s")
        rows = ptxas_summary(info["log"], cupdate.KINDS)
        for name, line, _ in rows:
            print(f"  ptxas {name}: {line}")
        framed = [name for name, line, _ in rows if needs_no_frame(name)
                  and any(frame_and_spills(line))]
        require(not framed, f"stack frame or spills in {framed}")
        # the static SASS mix of the two kernels the main path spends most
        # in, K1 Philox SU(3) heat-bath and K3 SU(3), and of K1 SU(3)
        # heat-bath drawing from each stream family, beside the constant
        # stream's (no generator): what each generator's code adds
        mixes = {}
        for name, _, mangled in rows:
            if name in ("stage_heatbath_su3_philox", "plane_sums_kernel<3>",
                        "plane_sums_tile_kernel<3>") or name in {
                            f"stage_heatbath_su3_{fam}" for fam in ps.FAMILIES}:
                mix = mixes[name] = sass_mix(info["path"], mangled)
                print(f"  SASS {name}: " + ("no cuobjdump" if mix is None
                      else ", ".join(f"{k} {v}" for k, v in mix.items())
                      + f"; total {sum(mix.values())} (static: a loop's "
                      "body counts once)"))
        base = mixes.get("stage_heatbath_su3_constant")
        for fam in ps.FAMILIES:
            mix = mixes.get(f"stage_heatbath_su3_{fam}")
            if base and mix and fam != "constant":
                print(f"  SASS stage_heatbath_su3_{fam} over the constant "
                      "stream's: " + ", ".join(
                          f"{k} {mix[k] - base[k]:+d}" for k in mix
                          if mix[k] != base[k]))
        build.library()

    hots = {}

    def hot(dims, n):
        if (dims, n) not in hots:
            cfg = SimConfig(group=n, dims=dims, seed=1)
            hots[(dims, n)] = engine.packed_hot_start(
                cfg, rng.make_base_key(1), dev)
        return hots[(dims, n)]

    def note_err(name, err):
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)

    last_mark = [time.perf_counter()]

    def mark(label):
        """Print the seconds since the last mark: where a phase spends its
        time."""
        now = time.perf_counter()
        print(f"-- {label}: {now - last_mark[0]:.1f} s")
        last_mark[0] = now

    def stream_state(gen, n, dims):
        return engine.make_stream_state0(
            SimConfig(group=n, dims=dims, seed=3, rng_mode=f"prngcl:{gen}"),
            dev)

    def k1_compare(n, kind, track, dims, k_trials, gen=None, n_hit=3):
        """The stages of a sweep (sweep_stages: all 8 at SMALL), in sweep
        order, on one hot start (and, with a stream generator gen, one set
        of streams, so each parity's words, pointer and luxury counter carry
        over its stages; gen "hw": Philox): the kernel runs on a copy of
        the inputs, the plain version on the originals, which carry on to
        the next stage.  Stream words
        and scalars must come out bit-identical.  -> (max |d| links, links
        beyond STAGE_TOL, links, kernel count, plain count)."""
        us = clone(hot(dims, n))
        stream = is_stream(gen)
        rst = stream_state(gen, n, dims) if stream else {}
        names = ps.kernel_scalar_names(gen) if stream else ()
        base = rng.make_base_key(1)
        worst, bad, links, cnt_k, cnt_p = 0.0, 0, 0, 0, 0
        for p, mu in sweep_stages("K1", dims):
            sfx = ("_e", "_o")[p]
            key = None if stream else rng.stage_key(base, 0, 4 * p + mu)
            kw_p = kw_k = {"rng_mode": "hw"} if gen == "hw" else {}
            if stream:
                kw_p = dict(gen=gen, words=rst["words" + sfx],
                            scalars={k: rst[k + sfx] for k in names})
                kw_k = dict(kw_p, words=kw_p["words"].clone(),
                            scalars=dict(kw_p["scalars"]))
            ck, cp = (
                (torch.zeros(1, dtype=torch.int64, device=dev)
                 for _ in range(2)) if track else (None, None))
            uk = clone(us)
            cupdate.stage_update(uk, mu, p, BETA_HOT[n], key, dims,
                                 k_trials, kind=kind, n_hit=n_hit,
                                 count=ck, **kw_k)
            cupdate.stage_update_ref(us, mu, p, BETA_HOT[n], key, dims,
                                     k_trials, kind=kind, n_hit=n_hit,
                                     count=cp, **kw_p)
            if stream:
                require(torch.equal(kw_k["words"], kw_p["words"])
                        and kw_k["scalars"] == kw_p["scalars"],
                        f"K1 {gen} {kind} SU({n}) {dims} (mu={mu}, "
                        f"p={p}): stream words or scalars differ")
                rst.update({k + sfx: v
                            for k, v in kw_p["scalars"].items()})
            d = (uk[2 * mu + p] - us[2 * mu + p]).abs().reshape(
                4 * n, -1).amax(dim=0)
            worst = max(worst, float(d.max()))
            bad += int((d > STAGE_TOL).sum())
            links += d.numel()
            if track:
                cnt_k += int(ck)
                cnt_p += int(cp)
        return worst, bad, links, cnt_k, cnt_p

    def k1a_compare(n, kind, track, k_trials, gen, dims, mesh):
        """K1a against its plain twin on the shards of dims on mesh: the
        stages of a sweep (sweep_stages) in sweep order, each on every
        shard (the kernel
        on a copy of the shard, the plain twin on the shard, which carries
        on), the halo refresh after each stage, stream words and scalars
        carried and bit-identical.  -> (max |d| links, links beyond
        STAGE_TOL, links, kernel count, plain count)."""
        grid = ShardGrid(dims, mesh, [dev])
        shards = sharded.shard_links(hot(dims, n), grid)
        stream = is_stream(gen)
        rst = (sharded.shard_streams(stream_state(gen, n, dims), grid)
               if stream else {})
        names = ps.kernel_scalar_names(gen) if stream else ()
        base = rng.make_base_key(1)
        worst, bad, links, cnt_k, cnt_p = 0.0, 0, 0, 0, 0
        for p, mu in sweep_stages("K1a", dims):
            sfx = ("_e", "_o")[p]
            key = None if stream else rng.stage_key(base, 0, 4 * p + mu)
            scal = {k: rst[k + sfx] for k in names}
            ck, cp = (
                (torch.zeros(1, dtype=torch.int64, device=dev)
                 for _ in range(2)) if track else (None, None))
            for i, (g, us) in enumerate(zip(grid.shards, shards)):
                kw_p = kw_k = {"rng_mode": "hw"} if gen == "hw" else {}
                if stream:
                    kw_p = dict(gen=gen, words=rst["words" + sfx][i],
                                scalars=dict(scal))
                    kw_k = dict(kw_p, words=kw_p["words"].clone(),
                                scalars=dict(scal))
                uk = clone(us)
                cupdate.stage_update(uk, mu, p, BETA_HOT[n], key, dims,
                                     k_trials, kind=kind, count=ck,
                                     shard=g, **kw_k)
                cupdate.stage_update_ref(us, mu, p, BETA_HOT[n], key,
                                         dims, k_trials, kind=kind,
                                         count=cp, shard=g, **kw_p)
                if stream:
                    require(torch.equal(kw_k["words"], kw_p["words"])
                            and kw_k["scalars"] == kw_p["scalars"],
                            f"K1a {gen} {kind} SU({n}) {dims} mesh "
                            f"{mesh} shard {i} (mu={mu}, p={p}): stream "
                            "words or scalars differ")
                # the whole padded shard: the kernel must leave the
                # halos and the other arrays alone
                for k, (a, b) in enumerate(zip(uk, us)):
                    d = (a - b).abs().amax(dim=(0, 1, 2))
                    worst = max(worst, float(d.max()))
                    if k == 2 * mu + p:  # its interior links
                        d = sharded.interior(d, g, 0)
                        bad += int((d > STAGE_TOL).sum())
                        links += d.numel()
            if stream:
                rst.update({k + sfx: v
                            for k, v in kw_p["scalars"].items()})
            sharded.refresh_halos(shards, grid, (2 * mu + p,))
            if track:
                cnt_k += int(ck)
                cnt_p += int(cp)
        return worst, bad, links, cnt_k, cnt_p

    scan_betas = cli._parse_betas(SCAN_GRID)

    chain_hots = {}

    def chain_inputs(dims, n, betas):
        """Chain-stacked hot starts (chain c under make_base_key(11 + 1000
        c); a copy, built once per shape) with their couplings and base
        keys on the card."""
        keys = [rng.make_base_key(11 + 1000 * c) for c in range(len(betas))]
        if (dims, n, len(keys)) not in chain_hots:
            chain_hots[(dims, n, len(keys))] = engine.packed_hot_start_chains(
                SimConfig(group=n, dims=dims), keys, dev)
        return (clone(chain_hots[(dims, n, len(keys))]),
                betas_tensor(betas, dev), keys_tensor(keys, dev), keys)

    def k1c_compare(n, kind, hw, dims, betas, k_trials):
        """K1c over the stages of a sweep (sweep index 3; sweep_stages) in
        sweep order,
        on C hot starts: each instantiation of (n, kind, random source) --
        untracked and, where the kind draws, tracked -- on its own copy of
        the inputs, K1 (tracked where the kind draws) on each chain's view
        of another copy (with that chain's beta and rng.stage_key), the
        plain twin on the originals, which carry on; tracking changes no
        link, so one twin serves both instantiations.  -> {track: (max |d|
        vs twin, max |d| vs K1, per-stage counts: kernel, twin, K1)}."""
        us, b_t, k_t, keys = chain_inputs(dims, n, betas)
        mode = "hw" if hw else "threefry"
        draws = kind != "overrelax"
        tracks = (False, True) if draws else (False,)

        def zeros():
            return torch.zeros(len(betas), dtype=torch.int64, device=dev)

        out = {t: [0.0, 0.0, ([], [], [])] for t in tracks}
        for p, mu in sweep_stages("K1c", dims):
            sid = 4 * p + mu
            c_p, c_1 = (zeros(), zeros()) if draws else (None, None)
            got = {}
            for t in tracks:
                got[t] = (clone(us), zeros() if t else None)
                cupdate.stage_update_chains(
                    got[t][0], mu, p, b_t, k_t, 3, sid, dims, k_trials,
                    kind=kind, count=got[t][1], rng_mode=mode)
            u1 = clone(us)
            for c, beta in enumerate(b_t.tolist()):
                key = rng.stage_key(keys[c], 3, sid) if draws else (0, 0)
                cupdate.stage_update(
                    tuple(a[c] for a in u1), mu, p, beta, key, dims,
                    k_trials, kind=kind, rng_mode=mode,
                    count=None if c_1 is None else c_1[c:c + 1])
            cupdate.stage_update_chains_ref(us, mu, p, b_t, k_t, 3, sid,
                                            dims, k_trials, kind=kind,
                                            count=c_p, rng_mode=mode)
            for t, (uk, c_k) in got.items():
                o = out[t]
                for a, b, c in zip(uk, us, u1):
                    o[0] = max(o[0], float((a - b).abs().max()))
                    o[1] = max(o[1], float((a - c).abs().max()))
                if t:
                    for lst, x in zip(o[2], (c_k, c_p, c_1)):
                        lst.append(x.tolist())
        return {t: tuple(o) for t, o in out.items()}

    def k1ac_compare(n, kind, hw, dims, betas, k_trials):
        """K1ac on the shards of dims on MESH over the stages of a sweep
        (sweep index 3; sweep_stages) in sweep order, C hot starts, as k1c_compare: each
        instantiation (untracked and, where the kind draws, tracked) on its
        own copy of the shards, K1a (tracked where the kind draws) on each
        chain's padded arrays of another copy, the plain twin on the
        originals; each copy's halos refreshed after every stage, whole
        padded arrays compared.  -> {track: (max |d| vs twin, max |d| vs
        K1a per chain, per-stage per-chain counts: kernel, twin, K1a)}."""
        us, b_t, k_t, keys = chain_inputs(dims, n, betas)
        grid = ShardGrid(dims, MESH, [dev])
        mode = "hw" if hw else "threefry"
        draws = kind != "overrelax"
        tracks = (False, True) if draws else (False,)

        def zeros():
            return torch.zeros(len(betas), dtype=torch.int64, device=dev)

        def stage(shards, k1a, mu, p, count):
            for g, sh in zip(grid.shards, shards):
                if not k1a:
                    cupdate.stage_update_chains(
                        sh, mu, p, b_t, k_t, 3, 4 * p + mu, dims, k_trials,
                        kind=kind, count=count, rng_mode=mode, shard=g)
                    continue
                for c, beta in enumerate(b_t.tolist()):
                    key = (rng.stage_key(keys[c], 3, 4 * p + mu) if draws
                           else (0, 0))
                    cupdate.stage_update(
                        tuple(a[c] for a in sh), mu, p, beta, key, dims,
                        k_trials, kind=kind, rng_mode=mode, shard=g,
                        count=None if count is None else count[c:c + 1])
            sharded.refresh_halos(shards, grid, (2 * mu + p,))

        base = sharded.shard_links(us, grid)
        got = {t: tuple(tuple(a.clone() for a in sh) for sh in base)
               for t in tracks}
        one = tuple(tuple(a.clone() for a in sh) for sh in base)
        out = {t: [0.0, 0.0, ([], [], [])] for t in tracks}
        for p, mu in sweep_stages("K1ac", dims):
            counts = {t: zeros() if t else None for t in tracks}
            c_p, c_1 = (zeros(), zeros()) if draws else (None, None)
            for t in tracks:
                stage(got[t], False, mu, p, counts[t])
            stage(one, True, mu, p, c_1)
            for g, sh in zip(grid.shards, base):
                cupdate.stage_update_chains_ref(
                    sh, mu, p, b_t, k_t, 3, 4 * p + mu, dims, k_trials,
                    kind=kind, count=c_p, rng_mode=mode, shard=g)
            sharded.refresh_halos(base, grid, (2 * mu + p,))
            for t in tracks:
                o = out[t]
                for shk, shp, sh1 in zip(got[t], base, one):
                    for a, b, c in zip(shk, shp, sh1):
                        o[0] = max(o[0], float((a - b).abs().max()))
                        o[1] = max(o[1], float((a - c).abs().max()))
                if t:
                    for lst, x in zip(o[2], (counts[t], c_p, c_1)):
                        lst.append(x.tolist())
        return {t: tuple(o) for t, o in out.items()}

    def k8_schedule():
        """K8's index schedule: one SU(3) and one SU(2) heat-bath stage
        (54 and 18 draws) at SMALL for every ranlux level, pointer and
        luxury counter in K8_NB0, and one SU(3) heat-bath stage for every
        ranmar pointer; then longer stages: K8_TRIALS KP trials (SU(3),
        subgroups of 34 draws) for every ranlux level at a few pointers and
        counters and for every ranmar pointer, and K8_HITS Metropolis hits
        (subgroups of 100 draws) for both groups at a few; unsharded and
        on shard 0 of MESH, each from the same words: the words and
        scalars must come out bit-identical to prng_streams.draw_words (the
        generator's twin, on the CPU, over the whole lattice's words; the
        shard's are its interior)."""
        grid = ShardGrid(SMALL, MESH, [dev])
        g0 = grid.shards[0]
        (x0, y0), (lx, ly) = g0.offset, g0.local
        hb, m = "heatbath", "metropolis"
        few = [(nb0, p0) for nb0 in (0, 24) for p0 in (0, 11, 23)]
        cases = [(f"ranlux{lv}", n, nb0, p0, hb, 4, 3) for lv in range(5)
                 for n in GROUPS for nb0 in K8_NB0 for p0 in range(24)]
        cases += [("ranmar", 3, None, p0, hb, 4, 3) for p0 in range(97)]
        cases += [(f"ranlux{lv}", 3, nb0, p0, hb, K8_TRIALS, 3)
                  for lv in range(5) for nb0, p0 in few]
        cases += [("ranmar", 3, None, p0, hb, K8_TRIALS, 3)
                  for p0 in range(97)]
        cases += [(f"ranlux{lv}", n, nb0, p0, m, 4, K8_HITS)
                  for lv in range(5) for n in GROUPS for nb0, p0 in few]
        cases += [("ranmar", n, None, p0, m, 4, K8_HITS) for n in GROUPS
                  for p0 in (0, 48, 96)]
        cases += [(f"ranlux{lv}", n, nb0, p0, kind, k_trials, n_hit)
                  for lv in range(5) for kind, k_trials, n_hit, n in K8_LONG
                  for nb0, p0 in ((23, 5),)]
        states, shard_links = {}, {}
        for gen, n, nb0, p0, kind, k_trials, n_hit in cases:
            if (gen, n) not in states:
                states[gen, n] = stream_state(gen, n, SMALL)
            if n not in shard_links:
                shard_links[n] = sharded.shard_links(hot(SMALL, n), grid)[0]
            rst = states[gen, n]
            words = rst["words_e"]
            scal = ({"nb": nb0, "ptr": p0} if nb0 is not None
                    else {"c": rst["c_e"], "ptr": p0})
            ndraw = cupdate.stream_draw_count(kind, k_trials, n_hit, n)
            twin = words.to("cpu", copy=True)
            ps.draw_words(gen, twin.reshape(twin.shape[0], -1), ndraw,
                          dict(scal))
            want = ps.advance_kernel_scalars(gen, scal, ndraw)
            for name, got, links, kw, ref in (
                    (instance(kind, n, False, gen), words.clone(),
                     clone(hot(SMALL, n)), {}, twin),
                    (instance(kind, n, False, gen, True),
                     words.narrow(1, x0, lx).narrow(2, y0, ly).contiguous(),
                     clone(shard_links[n]), dict(shard=g0),
                     twin.narrow(1, x0, lx).narrow(2, y0, ly))):
                sk = dict(scal)
                cupdate.stage_update(links, 0, 0, BETA_HOT[n], None, SMALL,
                                     k_trials, kind=kind, n_hit=n_hit,
                                     gen=gen, words=got, scalars=sk, **kw)
                require(torch.equal(got.cpu(), ref) and sk == want,
                        f"K8 schedule {name} {gen} {scal} K={k_trials} "
                        f"hits={n_hit} {SMALL}: words differ from "
                        "draw_words")
        print(f"K8 schedule: {len(cases)} stages x (unsharded, shard 0 of "
              f"{MESH}) at {SMALL}: ranlux0-4 x SU(3), SU(2) heat-bath x "
              f"pointer 0..23 x luxury counter {K8_NB0}, ranmar SU(3) "
              f"heat-bath x pointer 0..96; with {K8_TRIALS} KP trials "
              "ranlux0-4 SU(3) at 3 pointers x 2 counters and ranmar at "
              f"every pointer; Metropolis with {K8_HITS} hits, SU(3) and "
              "SU(2), ranlux0-4 at 3 pointers x 2 counters and ranmar at "
              "3 pointers; past a chunk of 413 draws a subgroup, ranlux0-4 "
              + ", ".join(f"SU({n}) {kind} K={k} hits={h}"
                          for kind, k, h, n in K8_LONG)
              + "; words bit-identical to draw_words")

    def k8_long_runs():
        """The long ranlux subgroups (K8_LONG) through the library:
        Simulation(cfg) on the card at STREAM_SMALL_RUN (which a limit on
        the subgroup's draws would refuse), one sweep from a hot start; a
        few sites' stream words and the scalars must come out bit-identical
        to draw_words over the sweep's draws (on the CPU: the words do not
        depend on the links), the plaquette must lie in (0, 1)."""
        sites = (0, 777, 2047)
        for (kind, k_trials, n_hit, n), gen in zip(K8_LONG, K8_LONG_GENS):
            cfg = SimConfig(group=n, beta=BETA_RUN[n], algorithm=kind,
                            kp_trials=k_trials, n_hit=n_hit,
                            dims=STREAM_SMALL_RUN, seed=5, start="hot",
                            rng_mode=f"prngcl:{gen}")
            sim = Simulation(cfg)
            st0 = {k: np.array(v) for k, v in sim.stream_state.items()}
            sim.thermalize(1)
            st1 = sim.stream_state
            plq = sim.measure()["plq"]
            ndraw = 4 * cupdate.stream_draw_count(kind, k_trials, n_hit, n)
            same = True
            for sfx in ("_e", "_o"):
                w0 = st0["words" + sfx]
                words = torch.from_numpy(
                    w0.reshape(w0.shape[0], -1)[:, sites].copy())
                scal = {k: int(st0[k + sfx])
                        for k in ps.kernel_scalar_names(gen)}
                ps.draw_words(gen, words, ndraw, dict(scal))
                want = ps.advance_kernel_scalars(gen, scal, ndraw)
                w1 = st1["words" + sfx]
                same = same and np.array_equal(
                    w1.reshape(w1.shape[0], -1)[:, sites], words.numpy()) \
                    and all(int(st1[k + sfx]) == v for k, v in want.items())
            per = cupdate.uniforms_per_subgroup(kind, k_trials, n_hit)
            msg = (f"Simulation {gen} SU({n}) {kind} K={k_trials} "
                   f"hits={n_hit} ({per} draws a subgroup) "
                   f"{STREAM_SMALL_RUN}, 1 sweep on the card: words of sites "
                   f"{sites} and scalars bit-identical to draw_words {same}, "
                   f"plaquette {plq:.6f}")
            print(msg)
            require(same and 0.0 < plq < 1.0, msg)

    def source_note(gen):
        return (f" ({gen}; words bit-identical)" if is_stream(gen)
                else " (hw: Philox; bit-identical)" if gen else "")

    def require_stage(msg, dims, n, kind, worst, bad, links, ck, cp, gen):
        """Below 32^4 kernel and plain version agree within STAGE_TOL with
        equal counts; at 32^4 an accept decision at a rounding boundary may
        flip (at most FLIP_FRACTION of the links), moving the count by at
        most the decisions of those links.  The Philox instantiations (K9's
        port, new here) must be bit-identical with equal counts at every
        shape."""
        if gen == "hw":
            require(worst == 0.0 and ck == cp, msg)
        elif dims != BIG:
            require(worst < STAGE_TOL and ck == cp, msg)
        else:
            n_sg = 3 if n == 3 else 1
            per_link = 3 if kind == "metropolis" else 1  # decisions/subgroup
            require(bad <= FLIP_FRACTION * links, msg)
            require(abs(ck - cp) <= bad * n_sg * per_link, msg)

    # phase 5's stream runs at STREAM_SMALL_RUN, one per stream
    # instantiation: (index, generator, group, kind, tracking)
    small_runs = [
        (i, FAMILY_RUN_GENS[fam][i % len(FAMILY_RUN_GENS[fam])], n, kind, t)
        for i, (fam, n, kind, t) in enumerate(itertools.product(
            ps.FAMILIES + ("philox",), GROUPS, DRAWING, (False, True)))]
    # phase 5's K1a runs at STREAM_SMALL_RUN, one per drawing K1a
    # instantiation, over SHARD_MESHES in turn (the overrelaxation ones ride
    # on the untracked threefry heat-bath runs' OR pass): (index, name,
    # generator or None, mesh)
    k1a_runs = []
    for i, name in enumerate(n_ for n_ in cupdate.SHARD_INSTANCES
                             if not n_.startswith("stage_overrelax")):
        fam = parse_instance(name)[3]
        gen = FAMILY_RUN_GENS[fam][i % len(FAMILY_RUN_GENS[fam])] if fam \
            else None
        k1a_runs.append((i, name, gen, SHARD_MESHES[i % len(SHARD_MESHES)]))

    with Phase("3 kernels vs plain versions"):
        mark("before phase 3")
        # K1 threefry at (4,4,2,4) and 32^4; K1 streams: every generator
        # at (4,4,2,4), every phase-5 run's at its shape, the four big
        # generators' SU(3) heat-bath and tracked Metropolis at 32^4
        cases = [(None, n, kind, track, dims) for n, kind, track in k1_cases
                 for dims in (SMALL, BIG)]
        cases += [(gen, n, kind, track, SMALL)
                  for gen in ps.STREAM_GENERATORS for n in GROUPS
                  for kind in ("heatbath", "metropolis")
                  for track in (False, True)]
        cases += [(gen, n, kind, track, STREAM_SMALL_RUN)
                  for _, gen, n, kind, track in small_runs]
        cases += [(gen, 3, kind, kind == "metropolis", BIG)
                  for gen in STREAM_BIG for kind in DRAWING]
        # K9 -> Philox: every instantiation at (4,4,2,4) (its own 8^4 run's
        # shape is in small_runs), SU(3) heat-bath at 32^4
        cases += [("hw", n, kind, track, SMALL) for n in GROUPS
                  for kind in DRAWING for track in (False, True)]
        cases += [("hw", 3, "heatbath", track, BIG) for track in (False, True)]
        for gen, n, kind, track, dims in cases:
            name = instance(kind, n, track, gen)
            # tracked heat-bath with one KP trial, so that exhaustions occur
            k_trials = 1 if (track and kind == "heatbath") else 4
            worst, bad, links, ck, cp = k1_compare(n, kind, track, dims,
                                                   k_trials, gen)
            note_err(name, worst)
            msg = (f"K1 {name}" + source_note(gen)
                   + f" {dims}: max |d| {worst:.3e}, {bad} of {links} links "
                   f"beyond {STAGE_TOL}")
            if track:
                msg += f"; count kernel {ck} plain {cp} (K={k_trials})"
            print(msg)
            require_stage(msg, dims, n, kind, worst, bad, links, ck, cp, gen)
        # K8's stages that ask more than 48 KB of shared memory: ranlux
        # Metropolis with K8_HITS hits, ranmar heat-bath with K8_TRIALS;
        # and the subgroups past a chunk (K8_LONG), whose refill only the
        # links and counts would show wrong (the words come out right
        # whichever chunk the sampler reads)
        long_cases = [(gen, n, kind, k, h) for (kind, k, h, n), gen
                      in zip(K8_LONG, K8_LONG_GENS)]
        for gen, n, kind, k_trials, n_hit in [
                ("ranlux3", 2, "metropolis", 4, K8_HITS),
                ("ranlux3", 3, "metropolis", 4, K8_HITS),
                ("ranmar", 3, "heatbath", K8_TRIALS, 3)] + long_cases:
            name = instance(kind, n, True, gen)
            worst, bad, links, ck, cp = k1_compare(n, kind, True, SMALL,
                                                   k_trials, gen, n_hit)
            note_err(name, worst)
            msg = (f"K1 {name}" + source_note(gen) + f" {SMALL} K={k_trials}"
                   f" hits={n_hit}: max |d| {worst:.3e}, {bad} of {links} "
                   f"links beyond {STAGE_TOL}; count kernel {ck} plain {cp}")
            print(msg)
            require_stage(msg, SMALL, n, kind, worst, bad, links, ck, cp, gen)
        mark("K1 threefry, streams, Philox")
        k8_schedule()
        mark("K8 schedule: every pointer, luxury counter and level")
        k8_long_runs()
        mark("K8 subgroups past a chunk through Simulation")
        for n in GROUPS:
            for dims in (SMALL, ODD_T2, BIG):
                u_ = hot(dims, n)
                # K2 on drifted links (hot start + seeded noise)
                noise = np.random.default_rng(1)
                k2 = 0.0
                for a in u_:
                    drift = a + torch.from_numpy(
                        noise.standard_normal(a.shape).astype(np.float32)
                    ).to(dev) * 1e-3
                    got = creunit.reunitarize_dir(drift.clone(), dims)
                    ref = creunit.reunitarize_dir_ref(drift.clone(), dims)
                    k2 = max(k2, float((got - ref).abs().max()))
                note_err(f"reunit_su{n}", k2)
                d3 = float((cmeasure.plane_sums(u_, dims)
                            - cmeasure.plane_sums_ref(u_, dims)).abs().max())
                d3 /= n * np.prod(dims)
                note_err(f"plane_sums_su{n}", d3)
                d4 = float((cmeasure.polyakov_sums(u_, dims)
                            - cmeasure.polyakov_sums_ref(u_, dims)
                            ).abs().max())
                d4 /= n * np.prod(dims[:3])
                note_err(f"polyakov_sums_su{n}", d4)
                msg = (f"SU({n}) {dims}: K2 max |d| {k2:.3e} (< {REUNIT_TOL})"
                       f"; K3 max |d sum|/(N vol) {d3:.3e} (< {PLANE_TOL})"
                       f"; K4 max |d sum|/(N spatial vol) {d4:.3e} "
                       f"(< {POLY_TOL})")
                print(msg)
                require(k2 < REUNIT_TOL and d3 < PLANE_TOL and d4 < POLY_TOL,
                        msg)
        mark("K2-K4")
        # K4 and K5b at the T/2 of phase 5's other paths (STREAM_SMALL_RUN:
        # 4, GATE_DIMS: 8, HUGE: 32, unsharded and on each shard of
        # HUGE_MESH) and at T/2 = 36 (LONG_T: two slot pairs a lane)
        for n, dims, mesh in [(n, d, None) for n in GROUPS for d in (
                STREAM_SMALL_RUN, GATE_DIMS, LONG_T)] + [
                (3, HUGE, None), (3, HUGE, HUGE_MESH)]:
            u_ = hot(dims, n)
            if mesh is None:
                name, where = f"polyakov_sums_su{n}", ""
                d4 = float((cmeasure.polyakov_sums(u_, dims)
                            - cmeasure.polyakov_sums_ref(u_, dims)
                            ).abs().max()) / (n * np.prod(dims[:3]))
            else:
                name, where = f"polyakov_sums_local_su{n}", f" mesh {mesh}"
                grid = ShardGrid(dims, mesh, [dev])
                d4 = 0.0
                for g, us in zip(grid.shards,
                                 sharded.shard_links(u_, grid)):
                    d4 = max(d4, float(
                        (cmeasure.polyakov_sums_local(us, g)
                         - cmeasure.polyakov_sums_local_ref(us, g)
                         ).abs().max()) / (n * np.prod(g.interior[:3])))
                del us
            note_err(name, d4)
            msg = (f"SU({n}) {dims}{where} (T/2 = {dims[3] // 2}, lanes a "
                   f"column {cmeasure.poly_lanes(dims[3] // 2)[2]}): "
                   f"{'K5b per shard' if mesh else 'K4'} max |d sum|/(N "
                   f"spatial vol) {d4:.3e} (< {POLY_TOL})")
            print(msg)
            require(d4 < POLY_TOL, msg)
        hots.pop((HUGE, 3))
        mark("K4, K5b at T/2 = 4, 8, 32, 36")
        # K1a: every instantiation on the shards of SHARD_SMALL on MESH
        # (partly filled blocks), again at the shape, mesh and generator of
        # its own phase-5 run (the overrelaxation ones: of the runs whose
        # OR pass drives them), and SU(3) heat-bath at 32^4 on MESH
        cases = [(name, family_source(parse_instance(name)[3]),
                  SHARD_SMALL, MESH) for name in cupdate.SHARD_INSTANCES]
        for _, name, gen, mesh in k1a_runs:
            kind, n, track, _ = parse_instance(name)
            cases.append((name, gen, STREAM_SMALL_RUN, mesh))
            if kind == "heatbath" and not track and gen is None:
                cases.append((cupdate.instance_name("overrelax", n,
                                                    shard=True),
                              None, STREAM_SMALL_RUN, mesh))
        cases += [(instance("heatbath", 3, track, src, True), src, BIG, MESH)
                  for src in (None, "hw") for track in (False, True)]
        for name, gen, dims, mesh in cases:
            kind, n, track, _ = parse_instance(name)
            k_trials = 1 if (track and kind == "heatbath") else 4
            worst, bad, links, ck, cp = k1a_compare(n, kind, track, k_trials,
                                                    gen, dims, mesh)
            note_err(name, worst)
            msg = (f"K1a {name}" + source_note(gen)
                   + f" {dims} mesh {mesh}: max |d| {worst:.3e}, {bad} of "
                   f"{links} links beyond {STAGE_TOL}")
            if track:
                msg += f"; count kernel {ck} plain {cp} (K={k_trials})"
            print(msg)
            require_stage(msg, dims, n, kind, worst, bad, links, ck, cp, gen)
        mark("K1a")
        # K5a / K5b per shard, on the XY, X and Y meshes
        for n in GROUPS:
            for dims, mesh in itertools.product(
                    (SHARD_SMALL, BIG), SHARD_MESHES[:3]):
                grid = ShardGrid(dims, mesh, [dev])
                d5a = d5b = 0.0
                for g, us in zip(grid.shards,
                                 sharded.shard_links(hot(dims, n), grid)):
                    vol = n * int(np.prod(g.interior))
                    d5a = max(d5a, float(
                        (cmeasure.plane_sums_local(us, g)
                         - cmeasure.plane_sums_local_ref(us, g)).abs().max())
                        / vol)
                    d5b = max(d5b, float(
                        (cmeasure.polyakov_sums_local(us, g)
                         - cmeasure.polyakov_sums_local_ref(us, g)
                         ).abs().max()) / (vol // dims[3]))
                note_err(f"plane_sums_local_su{n}", d5a)
                note_err(f"polyakov_sums_local_su{n}", d5b)
                msg = (f"SU({n}) {dims} mesh {mesh}, per shard: K5a max "
                       f"|d sum|/(N vol) {d5a:.3e} (< {PLANE_TOL}); K5b max "
                       f"|d sum|/(N spatial vol) {d5b:.3e} (< {POLY_TOL})")
                print(msg)
                require(d5a < PLANE_TOL and d5b < POLY_TOL, msg)
        mark("K5a, K5b")
        # K1c: every instantiation at SMALL and at STREAM_SMALL_RUN (the
        # shape of its own phase-5 scan) with 3 chains of distinct beta;
        # SU(3) HB (threefry and Philox, untracked and tracked) and OR at
        # SCAN_DIMS on the scan's 11 chains, heat-bath with the scan's K
        cases = [(n, kind, hw, dims, CHAIN_BETAS[n])
                 for dims in (SMALL, STREAM_SMALL_RUN) for n in GROUPS
                 for kind in cupdate.KINDS for hw in (False, True)
                 if not (hw and kind == "overrelax")]
        cases += [(3, kind, hw, SCAN_DIMS, scan_betas)
                  for kind, hw in (("heatbath", False), ("heatbath", True),
                                   ("overrelax", False))]
        for n, kind, hw, dims, betas in cases:
            t0 = time.perf_counter()
            # one KP trial below SCAN_DIMS, so that exhaustions occur
            k_trials = 1 if (kind == "heatbath" and dims != SCAN_DIMS) else 4
            res = k1c_compare(n, kind, hw, dims, betas, k_trials)
            secs = time.perf_counter() - t0
            for track, (d_twin, d_k1, (ck, cp, c1)) in res.items():
                name = cupdate.instance_name(kind, n, track, philox=hw and
                                             kind != "overrelax", chains=True)
                note_err(name, d_twin)
                msg = (f"K1c {name} {dims} x {len(betas)} chains: max |d| "
                       f"{d_twin:.3e} vs plain twin, {d_k1:.3e} vs K1 per "
                       f"chain")
                if track:
                    msg += (f"; per-chain counts kernel {ck[-1]} twin "
                            f"{cp[-1]} K1 {c1[-1]} (last stage, K={k_trials}"
                            f", {sum(map(sum, ck))} in the sweep)")
                print(msg + f" ({secs:.1f} s with its pair)")
                require(d_twin == 0.0 and d_k1 == 0.0 and ck == cp == c1, msg)
        mark("K1c")
        # K2c, K3c, K4c against their twins and against K2, K3, K4 on every
        # chain's arrays (bit-identical), at the shapes K1c is held at
        for n, dims, betas in [(n, dims, CHAIN_BETAS[n])
                               for dims in (SMALL, STREAM_SMALL_RUN)
                               for n in GROUPS] + [(3, SCAN_DIMS, scan_betas)]:
            us, _, _, _ = chain_inputs(dims, n, betas)
            nc = len(betas)
            noise = np.random.default_rng(2)
            k2_twin = k2_single = 0.0
            for a in us:
                drift = a + torch.from_numpy(
                    noise.standard_normal(a.shape).astype(np.float32)
                ).to(dev) * 1e-3
                got = creunit.reunitarize_chains(drift.clone(), dims)
                ref = creunit.reunitarize_chains_ref(drift.clone(), dims)
                one = drift.clone()
                for c in range(nc):
                    creunit.reunitarize_dir(one[c], dims)
                k2_twin = max(k2_twin, float((got - ref).abs().max()))
                k2_single = max(k2_single, float((got - one).abs().max()))
            p3, p4 = (cmeasure.plane_sums_chains(us, dims),
                      cmeasure.polyakov_sums_chains(us, dims))
            r3, r4 = (cmeasure.plane_sums_chains_ref(us, dims),
                      cmeasure.polyakov_sums_chains_ref(us, dims))
            views = [tuple(a[c] for a in us) for c in range(nc)]
            s3 = torch.stack([cmeasure.plane_sums(v, dims) for v in views])
            s4 = torch.stack([cmeasure.polyakov_sums(v, dims) for v in views])
            d3 = float((p3 - r3).abs().max()) / (n * np.prod(dims))
            d4 = float((p4 - r4).abs().max()) / (n * np.prod(dims[:3]))
            same = torch.equal(p3, s3) and torch.equal(p4, s4)
            note_err(f"reunit_chains_su{n}", k2_twin)
            note_err(f"plane_sums_chains_su{n}", d3)
            note_err(f"polyakov_sums_chains_su{n}", d4)
            msg = (f"SU({n}) {dims} x {nc} chains: K2c max |d| {k2_twin:.3e} "
                   f"vs twin (< {REUNIT_TOL}), {k2_single:.3e} vs K2 per "
                   f"chain; K3c |d sum|/(N vol) {d3:.3e} (< {PLANE_TOL}), "
                   f"K4c {d4:.3e} (< {POLY_TOL}) vs twins; K3c, K4c "
                   f"bit-identical to K3, K4 per chain: {same}")
            print(msg)
            require(k2_twin < REUNIT_TOL and k2_single == 0.0
                    and d3 < PLANE_TOL and d4 < POLY_TOL and same, msg)
        mark("K2c-K4c")
        # K1ac: every instantiation at STREAM_SMALL_RUN on MESH (the shape
        # and mesh of its own phase-5 scan) with 3 chains of distinct beta;
        # SU(3) HB (threefry and Philox, untracked and tracked) and OR at
        # SCAN_DIMS on MESH with the scan's 11 chains (config 3 on the
        # mesh); SU(3) HB and OR at the chain blocks of phase 5's other
        # mesh scans: the 32^4 layout scan's (both chains in one block, and
        # the second chain alone, as in its 2 blocks) and the CLI scan's
        # (12^3 x 6, its 2 blocks of 2 chains); heat-bath with the scans'
        # K
        cli_betas = cli._parse_betas(CLI_MESH_GRID)
        cases = [(n, kind, hw, STREAM_SMALL_RUN, CHAIN_BETAS[n])
                 for n in GROUPS for kind in cupdate.KINDS
                 for hw in (False, True) if not (hw and kind == "overrelax")]
        cases += [(3, kind, hw, SCAN_DIMS, scan_betas)
                  for kind, hw in (("heatbath", False), ("heatbath", True),
                                   ("overrelax", False))]
        cases += [(3, kind, False, dims, betas)
                  for dims, betas in ((BIG, LAYOUT_BETAS),
                                      (BIG, LAYOUT_BETAS[1:]),
                                      (CLI_MESH_DIMS, cli_betas[:2]),
                                      (CLI_MESH_DIMS, cli_betas[2:]))
                  for kind in ("heatbath", "overrelax")]
        for n, kind, hw, dims, betas in cases:
            t0 = time.perf_counter()
            k_trials = 1 if (kind == "heatbath"
                             and dims == STREAM_SMALL_RUN) else 4
            res = k1ac_compare(n, kind, hw, dims, betas, k_trials)
            secs = time.perf_counter() - t0
            for track, (d_twin, d_k1a, (ck, cp, c1)) in res.items():
                name = cupdate.instance_name(
                    kind, n, track, shard=True,
                    philox=hw and kind != "overrelax", chains=True)
                note_err(name, d_twin)
                msg = (f"K1ac {name} {dims} mesh {MESH} x {len(betas)} "
                       f"chains: max |d| {d_twin:.3e} vs plain twin, "
                       f"{d_k1a:.3e} vs K1a per chain")
                if track:
                    msg += (f"; per-chain counts kernel {ck[-1]} twin "
                            f"{cp[-1]} K1a {c1[-1]} (last stage, K="
                            f"{k_trials}, {sum(map(sum, ck))} in the sweep)")
                print(msg + f" ({secs:.1f} s with its pair)")
                require(d_twin == 0.0 and d_k1a == 0.0 and ck == cp == c1,
                        msg)
        mark("K1ac")
        require_all_stages()
        print("K1, K1a, K1c, K1ac: every (parity, mu) stage held against "
              "its plain twin at every shape: "
              + ", ".join(f"{fam} {tuple(d)} x{len(v)}"
                          for (fam, d), v in STAGES_TAKEN.items()))
        # K5ac, K5bc against their twins (PLANE_TOL, POLY_TOL) and against
        # K5a, K5b on every chain's padded arrays (bit-identical); K2c on
        # the padded arrays against K2 per chain, at the shapes K1ac is
        # held at
        for n, dims, betas in [(n, STREAM_SMALL_RUN, CHAIN_BETAS[n])
                               for n in GROUPS] + [
                (3, SCAN_DIMS, scan_betas), (3, BIG, LAYOUT_BETAS),
                (3, BIG, LAYOUT_BETAS[1:]), (3, CLI_MESH_DIMS, cli_betas[:2]),
                (3, CLI_MESH_DIMS, cli_betas[2:])]:
            us, _, _, _ = chain_inputs(dims, n, betas)
            grid = ShardGrid(dims, MESH, [dev])
            nc = len(betas)
            d5a = d5b = k2 = 0.0
            same = True
            for g, sh in zip(grid.shards, sharded.shard_links(us, grid)):
                vol = n * int(np.prod(g.interior))
                p3 = cmeasure.plane_sums_chains(sh, dims, g)
                p4 = cmeasure.polyakov_sums_chains(sh, dims, g)
                d5a = max(d5a, float(
                    (p3 - cmeasure.plane_sums_chains_ref(sh, dims, g)
                     ).abs().max()) / vol)
                d5b = max(d5b, float(
                    (p4 - cmeasure.polyakov_sums_chains_ref(sh, dims, g)
                     ).abs().max()) / (vol // dims[3]))
                for c in range(nc):
                    view = tuple(a[c] for a in sh)
                    same = same and torch.equal(
                        p3[c], cmeasure.plane_sums_local(view, g)) and (
                        torch.equal(p4[c],
                                    cmeasure.polyakov_sums_local(view, g)))
                drift = sh[5] * 1.001
                got = creunit.reunitarize_chains(drift.clone(), g.padded)
                for c in range(nc):
                    creunit.reunitarize_dir(drift[c], g.padded)
                k2 = max(k2, float((got - drift).abs().max()))
            note_err(f"plane_sums_local_chains_su{n}", d5a)
            note_err(f"polyakov_sums_local_chains_su{n}", d5b)
            msg = (f"SU({n}) {dims} mesh {MESH} x {nc} chains, per shard: "
                   f"K5ac |d sum|/(N vol) {d5a:.3e} (< {PLANE_TOL}), K5bc "
                   f"{d5b:.3e} (< {POLY_TOL}) vs twins; K5ac, K5bc "
                   f"bit-identical to K5a, K5b per chain: {same}; K2c on "
                   f"the padded arrays vs K2 per chain: max |d| {k2:.3e}")
            print(msg)
            require(d5a < PLANE_TOL and d5b < POLY_TOL and same and k2 == 0.0,
                    msg)
        mark("K5ac, K5bc, K2c on padded arrays")

    def time_pairs(pairs, dims, shard=None):
        """Time each (plain, kernel) pair: plain, kernel, kernel (the plain
        version is the correctness twin, timed once for the record);
        record ms, plain_ms and the bound of work(name, dims, shard) (the
        stages timed are stage (mu=1, parity=0), work()'s default)."""
        for name, (plain, kern, r_plain, r_kern, calls,
                   extra) in pairs.items():
            p1 = event_ms(plain, r_plain) / calls
            k1 = event_ms(kern, r_kern) / calls
            k2_ = event_ms(kern, r_kern) / calls
            rec = record[name]
            rec["ms"] = (k1 + k2_) / 2
            rec["plain_ms"] = p1
            nbytes, f32_ops, int_ops, f64_ops = work(name, dims, shard=shard)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes + extra, f32_ops,
                                                     int_ops, f64_ops)
            print(f"{name}: kernel {k1:.4f} / {k2_:.4f} ms, plain "
                  f"{p1:.4f} ms, bound {rec['bound_ms']:.4f} "
                  f"ms ({rec['bound_by']}), -fmad=false f32 floor "
                  f"{f32_ops / F32_INSTR_PER_S * 1e3:.4f} ms, integer "
                  f"floor {int_ops / INT32_OPS_PER_S * 1e3:.4f} ms"
                  + (f", f64 floor {f64_ops / F64_OPS_PER_S * 1e3:.4f} ms"
                     if f64_ops else "") + f"  [{smi}]")
            # the stream stages and the K4 family get theirs below
            if not (is_stream_row(name) or name.startswith("polyakov")):
                kernel_device(name, kern, r_kern, calls,
                              f"{dims}" + (" shard 0" if shard else ""))

    def kernel_device(name, fn, reps, calls, where):
        """A row's device time by the profiler (device_ms of the record: all
        the device work of fn, per launch of the row's kernel: fn makes
        calls of them), beside phase 4's CUDA-event time, which on short
        calls (up to ~0.1 ms of events) is the host's launch path."""
        match = next(k for k in ("reunit", "plane_sums", "stage")
                     if name.startswith(k))
        kern, total = device_ms(fn, reps, match)
        rec = record[name]
        rec["device_ms"] = None if total is None else total / calls
        print(f"{name} {where}: on the device " + (
            "not measured (the profiler saw no device event)"
            if kern is None else f"{kern / calls:.4f} ms {match} kernel, "
            f"{rec['device_ms']:.4f} ms all its device work (profiler, "
            f"{reps} calls); bound / device "
            f"{rec['bound_ms'] / rec['device_ms']:.3f}")
            + f"; CUDA events {rec['ms']:.4f} ms; bound "
            f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})  [{smi}]")

    def k4_device(name, fn, where):
        """A K4-family call's device time by the profiler (its kernel, and
        with the finish kernel: device_ms of the record), beside phase 4's
        CUDA-event time, which below ~0.05 ms is the host's launch path."""
        kern, total = device_ms(fn, 50, "polyakov_sums_kernel")
        rec = record[name]
        rec["device_ms"] = total
        print(f"{name} {where}: on the device " + (
            "not measured (the profiler saw no device event)"
            if kern is None else f"{kern:.4f} ms polyakov_sums_kernel, "
            f"{total:.4f} ms with the finish kernel (profiler, 50 calls)")
            + f"; CUDA events {rec['ms']:.4f} ms; bound "
            f"{rec['bound_ms']:.4f} ms  [{smi}]")

    def stream_device(n, fns):
        """The stream stages' device times by the profiler (device_ms of
        the record; each fn launches one stage kernel), beside phase 4's
        CUDA-event times, which below ~0.05 ms are the host's launch
        path."""
        t0 = time.perf_counter()
        got = {name: device_ms(fn, 20, "stage_kernel")[0]
               for name, fn in fns.items()}
        print(f"SU({n}): {len(fns)} stream stages under the profiler in "
              f"{time.perf_counter() - t0:.1f} s")
        for name, ms in got.items():
            rec = record[name]
            rec["device_ms"] = ms
            print(f"{name}: on the device " + (
                "not measured (the profiler saw no such kernel)" if ms is None
                else f"{ms:.4f} ms (profiler, 20 calls)")
                + f"; CUDA events {rec['ms']:.4f} ms; bound "
                f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})  [{smi}]")
        require(all(ms is not None for ms in got.values()) or not any(
            got.values()), f"SU({n}): the profiler saw some stream stages "
                "and not others: " + ", ".join(k for k, v in got.items()
                                                 if v is None))

    with Phase("4 kernel timing at 32^4 and 24^3 x 6"):
        key = rng.stage_key(rng.make_base_key(1), 0, 0)
        v2 = int(np.prod(BIG)) // 2
        for n in GROUPS:
            w = clone(hot(BIG, n))
            cnt = torch.zeros(1, dtype=torch.int64, device=dev)
            beta = BETA_RUN[n]
            # name -> (plain, kernel, plain reps, kernel reps, calls, bytes
            # beyond work(): a stream stage's state words)
            pairs = {}
            for n_, kind, track in k1_cases:
                if n_ != n:
                    continue
                c = cnt if track else None
                pairs[cupdate.instance_name(kind, n, track)] = (
                    lambda kind=kind, c=c: cupdate.stage_update_ref(
                        w, 1, 0, beta, key, BIG, kind=kind, count=c),
                    lambda kind=kind, c=c: cupdate.stage_update(
                        w, 1, 0, beta, key, BIG, kind=kind, count=c),
                    3, 50, 1, 0)
            # K9 -> Philox, under the same stage key
            for kind, track in itertools.product(DRAWING, (False, True)):
                kw = dict(kind=kind, count=cnt if track else None,
                          rng_mode="hw")
                pairs[instance(kind, n, track, "hw")] = (
                    lambda kw=kw: cupdate.stage_update_ref(
                        w, 1, 0, beta, key, BIG, **kw),
                    lambda kw=kw: cupdate.stage_update(
                        w, 1, 0, beta, key, BIG, **kw),
                    3, 50, 1, 0)
            # K1 streams: each family through one generator, on parity 0's
            # words and scalars (advanced by every call: the cost of a stage
            # does not depend on where the streams stand)
            for fam, gen in FAMILY_GEN.items():
                rst = stream_state(gen, n, BIG)
                scal = {k: rst[k + "_e"]
                        for k in ps.kernel_scalar_names(gen)}
                for kind in ("heatbath", "metropolis"):
                    ndraw = cupdate.stream_draw_count(kind, 4, 3, n)
                    extra = stream_word_bytes(gen, v2, ndraw, scal)
                    for track in (False, True):
                        c = cnt if track else None
                        kw = dict(kind=kind, count=c, gen=gen,
                                  words=rst["words_e"], scalars=scal)
                        pairs[cupdate.instance_name(kind, n, track, gen)] = (
                            lambda kw=kw: cupdate.stage_update_ref(
                                w, 1, 0, beta, None, BIG, **kw),
                            lambda kw=kw: cupdate.stage_update(
                                w, 1, 0, beta, None, BIG, **kw),
                            1, 20, 1, extra)
            # K2 as the sweep runs it: the 8 arrays in turn (one array
            # alone would stay in the 50 MB L2 from call to call)
            pairs[f"reunit_su{n}"] = (
                lambda: [creunit.reunitarize_dir_ref(a, BIG) for a in w],
                lambda: [creunit.reunitarize_dir(a, BIG) for a in w], 2, 25,
                len(w), 0)
            pairs[f"plane_sums_su{n}"] = (
                lambda: cmeasure.plane_sums_ref(w, BIG),
                lambda: cmeasure.plane_sums(w, BIG), 3, 100, 1, 0)
            pairs[f"polyakov_sums_su{n}"] = (
                lambda: cmeasure.polyakov_sums_ref(w, BIG),
                lambda: cmeasure.polyakov_sums(w, BIG), 3, 100, 1, 0)
            time_pairs(pairs, BIG)
            k4_device(f"polyakov_sums_su{n}",
                      lambda: cmeasure.polyakov_sums(w, BIG), f"{BIG}")
            # K1a, K5a and K5b on shard 0 of BIG on MESH; the halo refresh
            grid = ShardGrid(BIG, MESH, [dev])
            shards = sharded.shard_links(w, grid)
            g0, s0 = grid.shards[0], shards[0]
            v2s = int(np.prod(g0.interior)) // 2
            spairs = {}
            for n_, kind, track in k1_cases:
                if n_ != n:
                    continue
                kw = dict(kind=kind, count=cnt if track else None, shard=g0)
                spairs[cupdate.instance_name(kind, n, track, shard=True)] = (
                    lambda kw=kw: cupdate.stage_update_ref(
                        s0, 1, 0, beta, key, BIG, **kw),
                    lambda kw=kw: cupdate.stage_update(
                        s0, 1, 0, beta, key, BIG, **kw),
                    1, 20, 1, 0)
            for kind, track in itertools.product(DRAWING, (False, True)):
                kw = dict(kind=kind, count=cnt if track else None, shard=g0,
                          rng_mode="hw")
                spairs[instance(kind, n, track, "hw", True)] = (
                    lambda kw=kw: cupdate.stage_update_ref(
                        s0, 1, 0, beta, key, BIG, **kw),
                    lambda kw=kw: cupdate.stage_update(
                        s0, 1, 0, beta, key, BIG, **kw),
                    1, 20, 1, 0)
            for fam, gen in FAMILY_GEN.items():
                rst = sharded.shard_streams(stream_state(gen, n, BIG), grid)
                scal = {k: rst[k + "_e"]
                        for k in ps.kernel_scalar_names(gen)}
                for kind in ("heatbath", "metropolis"):
                    ndraw = cupdate.stream_draw_count(kind, 4, 3, n)
                    extra = stream_word_bytes(gen, v2s, ndraw, scal)
                    for track in (False, True):
                        kw = dict(kind=kind, count=cnt if track else None,
                                  gen=gen, words=rst["words_e"][0],
                                  scalars=scal, shard=g0)
                        spairs[cupdate.instance_name(kind, n, track, gen,
                                                     True)] = (
                            lambda kw=kw: cupdate.stage_update_ref(
                                s0, 1, 0, beta, None, BIG, **kw),
                            lambda kw=kw: cupdate.stage_update(
                                s0, 1, 0, beta, None, BIG, **kw),
                            1, 10, 1, extra)
            spairs[f"plane_sums_local_su{n}"] = (
                lambda: cmeasure.plane_sums_local_ref(s0, g0),
                lambda: cmeasure.plane_sums_local(s0, g0), 2, 50, 1, 0)
            spairs[f"polyakov_sums_local_su{n}"] = (
                lambda: cmeasure.polyakov_sums_local_ref(s0, g0),
                lambda: cmeasure.polyakov_sums_local(s0, g0), 2, 50, 1, 0)
            time_pairs(spairs, g0.interior, g0)
            # every stream stage (K7, K8; K1 and K1a) on the device as well
            stream_device(n, {name: kern
                              for name, (_, kern, *_) in itertools.chain(
                                  pairs.items(), spairs.items())
                              if is_stream_row(name)})
            # a ranlux subgroup past a column's draws (K8_LONG: the chunked
            # instantiation) on the device, beside its bound
            for (kind, k_trials, n_hit, n_), gen in zip(K8_LONG,
                                                        K8_LONG_GENS):
                if n_ != n:
                    continue
                rst = stream_state(gen, n, BIG)
                kw = dict(kind=kind, n_hit=n_hit, gen=gen,
                          words=rst["words_e"], scalars={
                              k: rst[k + "_e"]
                              for k in ps.kernel_scalar_names(gen)})
                kern, _ = device_ms(lambda kw=kw, k_trials=k_trials: (
                    cupdate.stage_update(w, 1, 0, beta, None, BIG, k_trials,
                                         **kw)), 10, "stage_kernel")
                name = cupdate.instance_name(kind, n, False, gen)
                ndraw = cupdate.stream_draw_count(kind, k_trials, n_hit, n)
                nbytes, f32_ops, _, _ = work(name, BIG, k_trials, n_hit)
                int_ops = v2 * rng_ops_per_site(n, kind, k_trials, n_hit,
                                                "ranlux", gen)[0]
                b_ms, by = bound(nbytes + stream_word_bytes(
                    gen, v2, ndraw, kw["scalars"]), f32_ops, int_ops)
                per = cupdate.uniforms_per_subgroup(kind, k_trials, n_hit)
                print(f"{name} {gen} K={k_trials} hits={n_hit} ({per} draws "
                      f"a subgroup, chunked) {BIG}: on the device "
                      + ("not measured (the profiler saw no such kernel)"
                         if kern is None else f"{kern:.4f} ms (profiler, 10 "
                         "calls)") + f"; bound {b_ms:.4f} ms ({by}), integer "
                      f"floor {int_ops / INT32_OPS_PER_S * 1e3:.4f} ms  "
                      f"[{smi}]")
            k4_device(f"polyakov_sums_local_su{n}",
                      lambda: cmeasure.polyakov_sums_local(s0, g0),
                      f"{BIG} mesh {MESH} shard 0")
            # the halo refresh of one array (after each stage): each shard
            # copies 2 Y rows over its interior X and 2 Y-padded X slabs
            (lx, ly), (hx, hy) = g0.local, g0.halo
            row = 16 * n * BIG[2] * BIG[3] // 2  # bytes of one (x, y) column
            h_bytes = 2 * len(grid) * 2 * row * (hy * lx + hx * (ly + 2 * hy))
            plan = sharded.halo_copies(shards, grid)  # as the sweep keeps it
            h1 = event_ms(lambda: sharded.refresh_halos(shards, grid, (2,),
                                                        plan), 50)
            h2 = event_ms(lambda: sharded.refresh_halos(shards, grid, (2,),
                                                        plan), 50)
            print(f"halo refresh of one array, {BIG} mesh {MESH}, SU({n}): "
                  f"{h1:.4f} / {h2:.4f} ms for {4 * len(grid)} copies, bound "
                  f"{h_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes "
                  f"{h_bytes})  [{smi}]")
            del w, pairs, spairs, shards, s0, plan
        hots.clear()

        # K1c-K4c at SCAN_DIMS on the scan's 11 chains (K1c: stage (mu=1,
        # parity 0) of sweep 0), each beside the loop of single-chain
        # launches on the chain views that it replaces, in the order plain,
        # kernel, loop, kernel, loop; bound = C x the single chain's work
        # (K1c also derives each drawing stage's key: one threefry call per
        # chain)
        nc = len(scan_betas)
        for n in GROUPS:
            us, b_t, k_t, keys = chain_inputs(SCAN_DIMS, n, scan_betas)
            views = [tuple(a[c] for a in us) for c in range(nc)]
            betas = b_t.tolist()
            cnt_c = torch.zeros(nc, dtype=torch.int64, device=dev)
            cnt_1 = torch.zeros(1, dtype=torch.int64, device=dev)
            keys1 = [rng.stage_key(k, 0, 1) for k in keys]
            # name -> (plain, kernel, loop, plain reps, reps, calls, the
            # single-chain name whose work C times is the bound, extra
            # integer operations)
            cpairs = {}
            for n_, kind, track in k1_cases:
                for hw in (False, True):
                    if n_ != n or (hw and kind == "overrelax"):
                        continue
                    ph = hw and kind != "overrelax"
                    kw = dict(kind=kind, count=cnt_c if track else None,
                              rng_mode="hw" if hw else "threefry")
                    kw1 = dict(kw, count=cnt_1 if track else None)
                    cpairs[cupdate.instance_name(
                        kind, n, track, philox=ph, chains=True)] = (
                        lambda kw=kw: cupdate.stage_update_chains_ref(
                            us, 1, 0, b_t, k_t, 0, 1, SCAN_DIMS, **kw),
                        lambda kw=kw: cupdate.stage_update_chains(
                            us, 1, 0, b_t, k_t, 0, 1, SCAN_DIMS, **kw),
                        lambda kw1=kw1, kind=kind: [
                            cupdate.stage_update(
                                v, 1, 0, betas[c], keys1[c]
                                if kind != "overrelax" else (0, 0),
                                SCAN_DIMS, **kw1)
                            for c, v in enumerate(views)],
                        1, 40, 1,
                        cupdate.instance_name(kind, n, track, philox=ph),
                        0 if kind == "overrelax"
                        else nc * THREEFRY_CALL_OPS)
            cpairs[f"reunit_chains_su{n}"] = (
                lambda: [creunit.reunitarize_chains_ref(a, SCAN_DIMS)
                         for a in us],
                lambda: [creunit.reunitarize_chains(a, SCAN_DIMS)
                         for a in us],
                lambda: [creunit.reunitarize_dir(a[c], SCAN_DIMS)
                         for a in us for c in range(nc)],
                1, 20, len(us), f"reunit_su{n}", 0)
            for k in ("plane_sums", "polyakov_sums"):
                kern, ref, one = (getattr(cmeasure, f"{k}_chains"),
                                  getattr(cmeasure, f"{k}_chains_ref"),
                                  getattr(cmeasure, k))
                cpairs[f"{k}_chains_su{n}"] = (
                    lambda ref=ref: ref(us, SCAN_DIMS),
                    lambda kern=kern: kern(us, SCAN_DIMS),
                    lambda one=one: [one(v, SCAN_DIMS) for v in views],
                    1, 40, 1, f"{k}_su{n}", 0)
            for name, (plain, kern, loop, r_plain, reps, calls, single,
                       extra) in cpairs.items():
                p1 = event_ms(plain, r_plain, warm=False) / calls
                k1 = event_ms(kern, reps) / calls
                l1 = event_ms(loop, reps) / calls
                k2_ = event_ms(kern, reps) / calls
                l2 = event_ms(loop, reps) / calls
                rec = record[name]
                rec["ms"], rec["plain_ms"] = (k1 + k2_) / 2, p1
                nbytes, f32_ops, int_ops, _ = work(single, SCAN_DIMS)
                rec["bound_ms"], rec["bound_by"] = bound(
                    nc * nbytes, nc * f32_ops, nc * int_ops + extra)
                print(f"{name} {SCAN_DIMS} x {nc} chains: kernel {k1:.4f} / "
                      f"{k2_:.4f} ms, the loop of {nc} single-chain launches "
                      f"it replaces {l1:.4f} / {l2:.4f} ms, plain {p1:.4f} "
                      f"ms, bound {rec['bound_ms']:.4f} ms "
                      f"({rec['bound_by']}), -fmad=false f32 floor "
                      f"{nc * f32_ops / F32_INSTR_PER_S * 1e3:.4f} ms  "
                      f"[{smi}]")
                if not name.startswith("polyakov"):
                    kernel_device(name, kern, reps, calls,
                                  f"{SCAN_DIMS} x {nc} chains")
            k4_device(f"polyakov_sums_chains_su{n}",
                      lambda: cmeasure.polyakov_sums_chains(us, SCAN_DIMS),
                      f"{SCAN_DIMS} x {nc} chains")
            del us, views, cpairs

        # K1ac, K5ac, K5bc on shard 0 of SCAN_DIMS on MESH over the scan's
        # 11 chains, as K1c above: each beside the loop of single-chain K1a
        # (K5a, K5b) launches on the chain views that it replaces; bound =
        # C x the single chain's work on the shard
        for n in GROUPS:
            us, b_t, k_t, keys = chain_inputs(SCAN_DIMS, n, scan_betas)
            grid = ShardGrid(SCAN_DIMS, MESH, [dev])
            g0 = grid.shards[0]
            s0 = sharded.shard_links(us, grid)[0]
            del us
            views = [tuple(a[c] for a in s0) for c in range(nc)]
            betas = b_t.tolist()
            cnt_c = torch.zeros(nc, dtype=torch.int64, device=dev)
            cnt_1 = torch.zeros(1, dtype=torch.int64, device=dev)
            keys1 = [rng.stage_key(k, 0, 1) for k in keys]
            cpairs = {}
            for n_, kind, track in k1_cases:
                for hw in (False, True):
                    if n_ != n or (hw and kind == "overrelax"):
                        continue
                    ph = hw and kind != "overrelax"
                    kw = dict(kind=kind, count=cnt_c if track else None,
                              rng_mode="hw" if hw else "threefry", shard=g0)
                    kw1 = dict(kw, count=cnt_1 if track else None)
                    cpairs[cupdate.instance_name(
                        kind, n, track, shard=True, philox=ph,
                        chains=True)] = (
                        lambda kw=kw: cupdate.stage_update_chains_ref(
                            s0, 1, 0, b_t, k_t, 0, 1, SCAN_DIMS, **kw),
                        lambda kw=kw: cupdate.stage_update_chains(
                            s0, 1, 0, b_t, k_t, 0, 1, SCAN_DIMS, **kw),
                        lambda kw1=kw1, kind=kind: [
                            cupdate.stage_update(
                                v, 1, 0, betas[c], keys1[c]
                                if kind != "overrelax" else (0, 0),
                                SCAN_DIMS, **kw1)
                            for c, v in enumerate(views)],
                        1, 40, cupdate.instance_name(kind, n, track,
                                                     shard=True, philox=ph),
                        0 if kind == "overrelax"
                        else nc * THREEFRY_CALL_OPS)
            for k in ("plane_sums", "polyakov_sums"):
                kern, ref, one = (getattr(cmeasure, f"{k}_chains"),
                                  getattr(cmeasure, f"{k}_chains_ref"),
                                  getattr(cmeasure, f"{k}_local"))
                cpairs[f"{k}_local_chains_su{n}"] = (
                    lambda ref=ref: ref(s0, SCAN_DIMS, g0),
                    lambda kern=kern: kern(s0, SCAN_DIMS, g0),
                    lambda one=one: [one(v, g0) for v in views],
                    1, 40, f"{k}_local_su{n}", 0)
            for name, (plain, kern, loop, r_plain, reps, single,
                       extra) in cpairs.items():
                p1 = event_ms(plain, r_plain, warm=False)
                k1 = event_ms(kern, reps)
                l1 = event_ms(loop, reps)
                k2_ = event_ms(kern, reps)
                l2 = event_ms(loop, reps)
                rec = record[name]
                rec["ms"], rec["plain_ms"] = (k1 + k2_) / 2, p1
                nbytes, f32_ops, int_ops, _ = work(single, g0.interior,
                                                shard=g0)
                rec["bound_ms"], rec["bound_by"] = bound(
                    nc * nbytes, nc * f32_ops, nc * int_ops + extra)
                print(f"{name} {SCAN_DIMS} mesh {MESH} shard 0 x {nc} "
                      f"chains: kernel {k1:.4f} / {k2_:.4f} ms, the loop of "
                      f"{nc} single-chain launches it replaces {l1:.4f} / "
                      f"{l2:.4f} ms, plain {p1:.4f} ms, bound "
                      f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}), "
                      f"-fmad=false f32 floor "
                      f"{nc * f32_ops / F32_INSTR_PER_S * 1e3:.4f} ms  "
                      f"[{smi}]")
                if not name.startswith("polyakov"):
                    kernel_device(name, kern, reps, 1, f"{SCAN_DIMS} mesh "
                                  f"{MESH} shard 0 x {nc} chains")
            k4_device(f"polyakov_sums_local_chains_su{n}",
                      lambda: cmeasure.polyakov_sums_chains(s0, SCAN_DIMS,
                                                            g0),
                      f"{SCAN_DIMS} mesh {MESH} shard 0 x {nc} chains")
            del s0, views, cpairs
        # every timed row has its device time, or the profiler saw none
        timed = [k for k, r in record.items() if r["ms"] is not None]
        missing = [k for k in timed if record[k]["device_ms"] is None]
        print(f"device time by the profiler for {len(timed) - len(missing)} "
              f"of the {len(timed)} rows timed in phase 4")
        require(not missing or len(missing) == len(timed),
                f"rows without a device time: {missing}")

    with Phase("5 main paths"):
        mark("before phase 5")
        # the library API on small hot starts: CUDA kernels vs CPU plain
        for label, _, kw in MAIN_PATHS[:4] + (
                ("streams: SU(3) heat-bath, prngcl:ranlux3", True,
                 dict(group=3, beta=6.0, rng_mode="prngcl:ranlux3")),
                ("sharded: SU(3) heat-bath + 1 OR, track_kp_exhaust, mesh "
                 f"{MESH}", True, dict(group=3, beta=6.0, n_or=1,
                                       track_kp_exhaust=True, mesh=MESH)),
                ("sharded: SU(3) heat-bath, prngcl:ranlux3, mesh (2,1,1,1)",
                 True, dict(group=3, beta=6.0, rng_mode="prngcl:ranlux3",
                            mesh=(2, 1, 1, 1)))):
            small = SimConfig(**kw, dims=SMALL, seed=1, start="hot",
                              reunit_every=2)
            obs_gpu = Simulation(small, device="cuda").run(2, 1)
            obs_cpu = Simulation(small, device="cpu").run(2, 1)
            d_plq = np.abs(obs_gpu[0, :4] - obs_cpu[0, :4]).max()
            d_pol = np.abs(obs_gpu[0, 4:6] - obs_cpu[0, 4:6]).max()
            d_rate = np.abs(obs_gpu[:, 6:] - obs_cpu[:, 6:]).max(initial=0.0)
            msg = (f"{label}, {SMALL}: row 0 |d| plq/action {d_plq:.2e}, "
                   f"poly {d_pol:.2e}; tracked column |d| {d_rate:.2e}")
            print(msg)
            require(d_plq < ROW_TOL[0] and d_pol < ROW_TOL[1]
                    and d_rate <= RATE_TOL, msg)

        def zero_counters():
            for c in counters:
                for k in c:
                    c[k] = 0

        def expected(cfg, n_sweeps, n_reunit, n_meas):
            """Launches per counter; on a mesh every launch is one per
            shard, of the shard instantiations and K5a/K5b."""
            n = cfg.group
            tracked = cfg.track_acceptance or cfg.track_kp_exhaust
            gen = ps.stream_mode_name(cfg.rng_mode)
            k = int(np.prod(cfg.mesh))
            sh, loc = k > 1, "_local" if k > 1 else ""
            expect = {
                cupdate.instance_name(cfg.algorithm, n, tracked, gen, sh,
                                      philox=cfg.rng_mode == "hw"):
                    8 * n_sweeps * k,
                f"plane_sums{loc}_su{n}": n_meas * k,
                f"polyakov_sums{loc}_su{n}": n_meas * k,
            }
            if n_reunit:
                expect[f"reunit_su{n}"] = 8 * n_reunit * k
            if cfg.n_or:
                expect[cupdate.instance_name("overrelax", n, shard=sh)] = (
                    8 * cfg.n_or * n_sweeps * k)
            return expect

        def check_run(label, sim, obs, launches, expect):
            cfg = sim.cfg
            tracked = cfg.track_acceptance or cfg.track_kp_exhaust
            plq = float(obs[-1, 0])
            defect = sim.unitarity_defect()
            tail = ""
            if tracked:
                col = obs[:, -1]
                tail = (f"; {sim.obs_names[-1]} mean {col.mean():.6e} "
                        f"(min {col.min():.6e}, max {col.max():.6e})")
                require(np.isfinite(col).all() and (col >= 0).all()
                        and (col <= 1).all(), f"{label}: tracked column")
            print(f"  plaquette {plq:.6f}; unitarity defect {defect:.3e}; "
                  f"launches {launches}{tail}")
            require(np.isfinite(obs).all(), f"{label}: bad series")
            # the constant debug generator samples no distribution
            if cfg.rng_mode != "prngcl:constant":
                require(0.3 < plq < 1.0, f"{label}: plaquette {plq}")
            require(defect < 1e-5, f"{label}: unitarity defect {defect}")
            require(launches == expect,
                    f"{label}: launches {launches}, expected {expect}")
            for k, v in launches.items():
                record[k]["launches"] += v

        def idle_share(sim):
            wall, wall_prof, busy, by_name = profile_window(sim, 5)
            if busy is None:
                print("  idle share: not measured (the profiler saw no "
                      "device event)")
                return
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
            print(f"  thermalize(5) + run(5, 1): wall {wall:.3f} ms "
                  f"({wall_prof:.3f} ms under the profiler), device "
                  f"busy {busy:.3f} ms, idle share "
                  f"{1 - busy / wall:.4f} "
                  f"({1 - busy / wall_prof:.4f} under the "
                  f"profiler)  [{smi}]")
            for kname, (ms, calls) in top[:6]:
                print(f"    {ms:9.3f} ms {calls:5d} calls  "
                      f"{kname[:90]}")

        def drive(label, cfg, profile, keep=False):
            """The 32^4 main path: Simulation(cfg) on the card by default,
            warmup(), thermalize(THERM), run(RUN, 1), counters zeroed
            before and read after.  -> a copy of the final links (the
            global packed 8-tuple) with keep, else None."""
            n_sweeps = 2 + THERM + RUN  # warmup() runs 1 sweep + 1 measured
            n_reunit = sum(1 for i in range(THERM + RUN) if i % 10 == 9)
            expect = expected(cfg, n_sweeps, n_reunit, 1 + RUN)
            zero_counters()
            t0 = time.perf_counter()
            sim = Simulation(cfg)  # the card, by default
            sim.sync()
            t_init = time.perf_counter()
            sim.warmup()
            t1 = time.perf_counter()
            sim.thermalize(THERM).sync()
            t2 = time.perf_counter()
            obs = sim.run(RUN, 1)
            t3 = time.perf_counter()
            launches = {k: v for c in counters for k, v in c.items() if v}
            therm_ms = (t2 - t1) / THERM * 1e3
            run_ms = (t3 - t2) / RUN * 1e3
            n_links = 4 * int(np.prod(BIG))
            print(f"{label}: start state built in {t_init - t0:.3f} s; "
                  f"warmup {t1 - t_init:.2f} s; thermalize "
                  f"{therm_ms:.3f} ms/sweep "
                  f"({n_links / therm_ms * 1e3:.4e} link-updates/s); run "
                  f"with measurement {run_ms:.3f} ms/sweep "
                  f"({n_links / run_ms * 1e3:.4e} link-updates/s)  [{smi}]")
            require(obs.shape == (RUN, len(sim.obs_names)),
                    f"{label}: series shape {obs.shape}")
            check_run(label, sim, obs, launches, expect)
            final = tuple(a.clone() for a in sim.us) if keep else None
            if profile:
                idle_share(sim)
            del sim
            return final

        bench = SimConfig(group=3, beta=6.0, dims=BIG, reunit_every=10,
                          start="cold", seed=0)
        bench_us = None
        for label, profiled, kw in MAIN_PATHS:
            us = drive(label, SimConfig(**kw, dims=BIG, reunit_every=10,
                                        start="cold", seed=0,
                                        rng_mode="threefry"), profiled,
                       keep=bench_us is None)
            bench_us = bench_us or us
        for gen in STREAM_BIG:
            drive(f"streams: SU(3) heat-bath, prngcl:{gen}",
                  SimConfig(group=3, beta=6.0, dims=BIG, reunit_every=10,
                            start="cold", seed=0, rng_mode=f"prngcl:{gen}"),
                  gen == "ranlux3")
        # K9 -> Philox: the bench's own configuration (bench.py:270-291,
        # rng_mode="hw")
        hw_us = drive("bench hw: SU(3) heat-bath, rng_mode='hw' (Philox)",
                      bench.replace(rng_mode="hw"), True, keep=True)

        mark("32^4 main paths")
        # every stream and Philox instantiation on a path of its own at 8^4:
        # warmup(), thermalize(2), run(2, 1), reunit_every=2, alternating
        # cold and hot starts (the stream hot start, or threefry's for hw;
        # the constant generator's would be degenerate), one in three with
        # 1 OR pass
        for i, gen, n, kind, track in small_runs:
            kw = dict(group=n, beta=BETA_RUN[n], algorithm=kind,
                      dims=STREAM_SMALL_RUN, reunit_every=2,
                      start=("cold", "hot")[i % 2 and gen != "constant"],
                      seed=i, n_or=int(i % 3 == 0), rng_mode=rng_mode_of(gen))
            if track:
                kw["track_kp_exhaust" if kind == "heatbath"
                   else "track_acceptance"] = True
            cfg = SimConfig(**kw)
            zero_counters()
            sim = Simulation(cfg)
            sim.warmup()
            sim.thermalize(2)
            obs = sim.run(2, 1)
            launches = {k: v for c in counters for k, v in c.items() if v}
            label = (f"{gen} SU({n}) {kind} track={track} n_or={cfg.n_or} "
                     f"{cfg.start} {STREAM_SMALL_RUN}")
            print(label)
            check_run(label, sim, obs, launches, expected(cfg, 6, 2, 3))

        mark("8^4 stream and Philox runs")
        # every K1a instantiation on a path of its own at 8^4, as the
        # stream instantiations above, over the X, Y and XY meshes in turn;
        # the untracked threefry heat-bath runs add 1 OR pass (the
        # overrelaxation instantiations)
        for i, name, gen, mesh in k1a_runs:
            kind, n, track, _ = parse_instance(name)
            kw = dict(group=n, beta=BETA_RUN[n], algorithm=kind,
                      dims=STREAM_SMALL_RUN, reunit_every=2,
                      start=("cold", "hot")[i % 2 and gen != "constant"],
                      seed=i, n_or=int(kind == "heatbath" and not track
                                       and gen is None),
                      rng_mode=rng_mode_of(gen), mesh=mesh)
            if track:
                kw["track_kp_exhaust" if kind == "heatbath"
                   else "track_acceptance"] = True
            cfg = SimConfig(**kw)
            zero_counters()
            sim = Simulation(cfg)
            sim.warmup()
            sim.thermalize(2)
            obs = sim.run(2, 1)
            launches = {k: v for c in counters for k, v in c.items() if v}
            label = (f"K1a {name}: {cfg.rng_mode} n_or={cfg.n_or} "
                     f"{cfg.start} {STREAM_SMALL_RUN} mesh {cfg.mesh}")
            print(label)
            check_run(label, sim, obs, launches, expected(cfg, 6, 2, 3))

        mark("8^4 K1a runs")
        # the sharded path: the bench configuration (threefry and hw) on
        # MESH through the library, then links bit-identical to the
        # unsharded chain
        for mode, ref_us, prof in (("threefry", bench_us, True),
                                   ("hw", hw_us, True)):
            us = drive(f"sharded: bench SU(3) heat-bath, {mode}, mesh {MESH}",
                       bench.replace(mesh=MESH, rng_mode=mode), prof,
                       keep=True)
            same = all(torch.equal(a, b) for a, b in zip(us, ref_us))
            print(f"  links after {2 + THERM + RUN} sweeps bit-identical to "
                  f"the unsharded run: {same}")
            require(same, f"{mode} mesh {MESH}: links differ from the "
                    "unsharded chain")
        del us, bench_us, hw_us, ref_us

        mark("sharded bench")
        # the command line on the bench's hw configuration: run with
        # periodic checkpoints, then resume, each with its launches counted;
        # the resumed chain (series and links) equals an uninterrupted one
        # bit for bit
        def cli_launches(label, argv, expect):
            zero_counters()
            cli.main(argv)
            launches = {k: v for c in counters for k, v in c.items() if v}
            print(f"CLI {label}: launches {launches}")
            require(launches == expect,
                    f"CLI {label}: launches {launches}, expected {expect}")
            for k, v in launches.items():
                record[k]["launches"] += v

        hw = bench.replace(rng_mode="hw")
        with tempfile.TemporaryDirectory() as tmp:
            a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
            # warmup() runs 1 sweep + 1 measured, thermalize 10 and run 10
            # sweeps 0-19 (reunitarized after 9 and 19); resume's warmup
            # and run 10 sweeps 20-29 (after 29)
            cli_launches("run", ["run", "--dims", "32", "--rng-mode", "hw",
                                 "--therm", "10", "--sweeps", "10",
                                 "--ckpt-every", "5", "--out", a],
                         expected(hw, 22, 2, 11))
            cli_launches("resume", ["resume", os.path.join(a, "state.npz"),
                                    "--sweeps", "10", "--out", b],
                         expected(hw, 12, 1, 11))
            recs = []
            for d in (a, b):
                with open(os.path.join(d, "results.json")) as f:
                    recs.append(json.load(f))
            links_b = [np.load(os.path.join(b, "state.npz",
                                            f"links_pk_{k}.npy"))
                       for k in range(8)]
        for label, rec in zip(("run", "resume"), recs):
            print(f"CLI {label} (32^4 hw) timings: {rec['timings']}  [{smi}]")
        sim = Simulation(hw.replace(sweeps_therm=10, sweeps=20,
                                    ckpt_every=5))
        sim.warmup().thermalize()
        obs = sim.run()
        series = recs[1]["series"]
        same_series = all(
            np.array_equal(np.asarray(series[name], np.float32), obs[:, k])
            for k, name in enumerate(sim.obs_names))
        same_links = all(np.array_equal(x, y.cpu().numpy())
                         for x, y in zip(links_b, sim.us))
        print(f"CLI run 10 + 10 sweeps, then resume 10: series "
              f"({len(series['plq'])} rows) and links bit-identical to an "
              f"uninterrupted run: {same_series and same_links}")
        require(same_series and same_links and len(series["plq"]) == 20,
                "CLI run + resume differs from the uninterrupted chain")
        mark("CLI run + resume")
        # the native analysis library: built here, the records' backend
        analysis_check(recs, obs[:, 0], smi)
        del sim, links_b

        mark("native analysis")

        def same_chain(label, cfg, mesh, n_sweeps):
            """Simulation(cfg) unsharded and on mesh, thermalize(n_sweeps)
            each from the same start: links (and stream state) must be
            bit-identical."""
            states = []
            for m in ((1, 1, 1, 1), mesh):
                sim = Simulation(cfg.replace(mesh=m))
                t0 = time.perf_counter()
                sim.thermalize(n_sweeps).sync()
                ms = (time.perf_counter() - t0) / n_sweeps * 1e3
                states.append((sim.us, sim.stream_state, ms))
                del sim
            (u1, s1, ms1), (un, sn, msn) = states
            same = all(torch.equal(a, b) for a, b in zip(u1, un))
            if s1 is not None:
                same = same and all(np.array_equal(s1[k], sn[k]) for k in s1)
            print(f"{label}: mesh {mesh} vs unsharded after {n_sweeps} "
                  f"sweeps: bit-identical {same} ({msn:.3f} vs {ms1:.3f} "
                  f"ms/sweep, first sweeps included)  [{smi}]")
            require(same, f"{label}: mesh {mesh} differs from unsharded")

        for mesh in ((4, 1, 1, 1), (1, 4, 1, 1)):
            same_chain("bench SU(3) heat-bath 32^4", bench, mesh, 12)
        same_chain("SU(3) heat-bath 32^4 prngcl:ranlux3",
                   bench.replace(rng_mode="prngcl:ranlux3"), (2, 1, 1, 1), 12)
        # K1b's check: SU(3) 64^4, which the TPU runs Y-tiled, on 8 Y shards
        same_chain("SU(3) heat-bath 64^4", bench.replace(dims=(64,) * 4),
                   (1, 8, 1, 1), 2)

        mark("sharded vs unsharded chains")

        # the beta scan, BASELINE config 3: SU(3) 24^3 x 6 HB + 2 OR, cold,
        # reunit_every=10, the grid 5.6:6.1:11, through BetaScan on the card
        def expected_chains(cfg, n_sweeps, n_reunit, n_meas, blocks=1):
            """Launches per counter of a scan: per chain block, one K1c
            launch per stage and one K2c launch per array, K3c + K4c per
            measurement, for all its chains at once; on a mesh each of
            them once per shard, of K1ac and K5ac / K5bc."""
            n = cfg.group
            tracked = cfg.track_acceptance or cfg.track_kp_exhaust
            k = int(np.prod(cfg.mesh))
            sh, loc, per = k > 1, "_local" if k > 1 else "", k * blocks
            expect = {
                cupdate.instance_name(cfg.algorithm, n, tracked, shard=sh,
                                      philox=cfg.rng_mode == "hw",
                                      chains=True): 8 * n_sweeps * per,
                f"plane_sums{loc}_chains_su{n}": n_meas * per,
                f"polyakov_sums{loc}_chains_su{n}": n_meas * per,
            }
            if n_reunit:
                expect[f"reunit_chains_su{n}"] = 8 * n_reunit * per
            if cfg.n_or:
                expect[cupdate.instance_name("overrelax", n, shard=sh,
                                             chains=True)] = (
                    8 * cfg.n_or * n_sweeps * per)
            return expect

        def drive_scan(label, cfg, flat=None):
            """BetaScan(cfg, the scan grid) on the card by default:
            warmup(), thermalize(THERM), run(RUN, 1), counters zeroed
            before and read after; then the idle share; then each chain
            against its own Simulation (sharded on cfg's mesh), run one
            after the other (links and series bit-identical); with flat
            (the unsharded scan's links and series) the links must equal
            its links bit for bit and the series its series within 1e-6.
            -> (links, series)."""
            n_sweeps = 2 + THERM + RUN
            n_reunit = sum(1 for i in range(THERM + RUN) if i % 10 == 9)
            expect = expected_chains(cfg, n_sweeps, n_reunit, 1 + RUN)
            zero_counters()
            t0 = time.perf_counter()
            scan = BetaScan(cfg, scan_betas)
            scan.sync()
            t_init = time.perf_counter()
            scan.warmup()
            t1 = time.perf_counter()
            scan.thermalize(THERM).sync()
            t2 = time.perf_counter()
            obs = scan.run(RUN, 1)
            t3 = time.perf_counter()
            launches = {k: v for c in counters for k, v in c.items() if v}
            nc = len(scan_betas)
            therm_ms = (t2 - t1) / THERM * 1e3
            run_ms = (t3 - t2) / RUN * 1e3
            n_links = 4 * int(np.prod(cfg.dims)) * nc
            print(f"{label}: start state built in {t_init - t0:.3f} s; "
                  f"warmup {t1 - t_init:.2f} s; thermalize {therm_ms:.3f} "
                  f"ms/sweep for {nc} chains ({therm_ms / nc:.4f} per "
                  f"chain; {n_links / therm_ms * 1e3:.4e} link-updates/s); "
                  f"run with measurement {run_ms:.3f} ms/sweep "
                  f"({run_ms / nc:.4f} per chain)  [{smi}]")
            plq = obs[:, -1, 0]
            print(f"  plaquette by beta {[round(float(x), 5) for x in plq]}; "
                  f"launches {launches}; per sweep "
                  f"{sum(v for k, v in expect.items() if k.startswith('stage_')) / n_sweeps:.0f} "
                  f"stage launches")
            require(obs.shape == (nc, RUN, len(scan.obs_names))
                    and np.isfinite(obs).all(), f"{label}: bad series")
            require(((0.3 < plq) & (plq < 1.0)).all() and plq[-1] > plq[0],
                    f"{label}: plaquette {plq}")
            require(launches == expect,
                    f"{label}: launches {launches}, expected {expect}")
            for k, v in launches.items():
                record[k]["launches"] += v
            scan_us = tuple(a.clone() for a in scan.us)
            if flat is not None:
                same_links = all(torch.equal(a, b)
                                 for a, b in zip(scan_us, flat[0]))
                d_obs = float(np.abs(obs - flat[1]).max())
                print(f"  against the unsharded scan: links bit-identical "
                      f"{same_links}; series max |d| {d_obs:.3e} (< 1e-6), "
                      f"bit-identical {bool(np.array_equal(obs, flat[1]))}")
                require(same_links and d_obs < 1e-6,
                        f"{label}: differs from the unsharded scan")
            idle_share(scan)
            del scan
            t0 = time.perf_counter()
            same, seq_therm, seq_run = [], 0.0, 0.0
            for c, beta in enumerate(np.asarray(scan_betas, np.float32)):
                sim = Simulation(cfg.replace(seed=cfg.seed + 1000 * c,
                                             beta=float(beta)))
                sim.warmup()
                t1 = time.perf_counter()
                sim.thermalize(THERM).sync()
                t2 = time.perf_counter()
                o = sim.run(RUN, 1)
                seq_therm += t2 - t1
                seq_run += time.perf_counter() - t2
                same.append(bool(np.array_equal(o, obs[c]) and all(
                    torch.equal(a[c], b) for a, b in zip(scan_us, sim.us))))
                del sim
            seq_ms = (time.perf_counter() - t0) / n_sweeps * 1e3
            print(f"  {nc} Simulations one after the other (seed + 1000 c, "
                  f"betas[c], mesh {tuple(cfg.mesh)}; warmup, "
                  f"thermalize({THERM}), run({RUN}, 1)): "
                  f"thermalize {seq_therm / THERM * 1e3:.3f} ms/sweep of all "
                  f"chains (the scan: {therm_ms:.3f}), run with measurement "
                  f"{seq_run / RUN * 1e3:.3f} (the scan: {run_ms:.3f}); "
                  f"{seq_ms:.3f} ms per sweep with build and warmup; each "
                  f"bit-identical to its scan chain (links, series): "
                  f"{same}  [{smi}]")
            require(all(same), f"{label}: chains differ from Simulations")
            return scan_us, obs

        # config 3 unsharded, then on MESH (the chain x lattice scan: K1ac,
        # K5ac, K5bc), each chain against the unsharded scan and its
        # sharded Simulation
        scan3 = baseline_config(3)
        for mode in ("threefry", "hw"):
            flat = drive_scan(f"scan: BASELINE config 3, SU(3) {SCAN_DIMS} "
                              f"HB + 2 OR, {SCAN_GRID}, {mode}",
                              scan3.replace(rng_mode=mode))
            drive_scan(f"scan on mesh {MESH}: BASELINE config 3, SU(3) "
                       f"{SCAN_DIMS} HB + 2 OR, {SCAN_GRID}, {mode}",
                       scan3.replace(rng_mode=mode, mesh=MESH), flat)
            del flat

        mark("config-3 scans, unsharded and on the mesh")

        # the reference's example of the layout: a 2-beta scan of 32^4
        # lattices on MESH in 2 chain blocks (here on one card), against
        # one block: links and series bit-identical
        layout = SimConfig(group=3, dims=BIG, reunit_every=10, start="cold",
                           seed=0, mesh=MESH)
        runs = []
        for blocks in (1, 2):
            zero_counters()
            scan = BetaScan(layout, LAYOUT_BETAS, blocks)
            scan.warmup()
            t1 = time.perf_counter()
            scan.thermalize(10).sync()
            t2 = time.perf_counter()
            obs = scan.run(10, 1)
            t3 = time.perf_counter()
            launches = {k: v for c in counters for k, v in c.items() if v}
            expect = expected_chains(layout, 22, 2, 11, blocks)
            print(f"scan SU(3) {BIG} betas {LAYOUT_BETAS} on mesh {MESH}, "
                  f"chain_mesh {blocks}: thermalize {(t2 - t1) * 1e2:.3f} "
                  f"ms/sweep, run with measurement {(t3 - t2) * 1e2:.3f} "
                  f"ms/sweep; plaquette {obs[:, -1, 0].tolist()}; launches "
                  f"{launches}  [{smi}]")
            require(launches == expect, f"chain_mesh {blocks}: launches "
                    f"{launches}, expected {expect}")
            for k, v in launches.items():
                record[k]["launches"] += v
            runs.append((tuple(a.clone() for a in scan.us), obs))
            del scan
        same = (all(torch.equal(a, b) for a, b in zip(*(r[0] for r in runs)))
                and np.array_equal(runs[0][1], runs[1][1]))
        print(f"  chain_mesh 2 against 1: links and series bit-identical "
              f"{same}")
        require(same, "32^4 layout scan: chain_mesh 2 differs from 1")
        del runs

        mark("32^4 layout scan")

        # every K1c and K1ac instantiation through a scan of its own at
        # 8^4, 3 chains of distinct beta, unsharded and on MESH: warmup(),
        # thermalize(2), run(2, 1), reunit_every=2, alternating cold and
        # hot starts, one in three with 1 OR pass (the overrelaxation
        # instantiations)
        for i, (mesh, n, kind, track, hw) in enumerate(itertools.product(
                ((1, 1, 1, 1), MESH), GROUPS, DRAWING, (False, True),
                (False, True))):
            kw = dict(group=n, algorithm=kind, dims=STREAM_SMALL_RUN,
                      reunit_every=2, start=("cold", "hot")[i % 2], seed=i,
                      n_or=int(i % 3 == 0), mesh=mesh,
                      rng_mode="hw" if hw else "threefry")
            if track:
                kw["track_kp_exhaust" if kind == "heatbath"
                   else "track_acceptance"] = True
            cfg = SimConfig(**kw)
            zero_counters()
            scan = BetaScan(cfg, CHAIN_BETAS[n])
            scan.warmup().thermalize(2)
            obs = scan.run(2, 1)
            launches = {k: v for c in counters for k, v in c.items() if v}
            expect = expected_chains(cfg, 6, 2, 3)
            label = (f"scan {cfg.rng_mode} SU({n}) {kind} track={track} "
                     f"n_or={cfg.n_or} {cfg.start} {STREAM_SMALL_RUN} mesh "
                     f"{mesh} x {len(CHAIN_BETAS[n])} chains")
            plq = [round(float(x), 5) for x in obs[:, -1, 0]]
            print(f"{label}: plaquette {plq}"
                  + (f", {scan.obs_names[-1]} {obs[:, :, -1].tolist()}"
                     if track else ""))
            require(obs.shape == (3, 2, len(scan.obs_names))
                    and np.isfinite(obs).all(), f"{label}: bad series")
            if track:
                require(((obs[:, :, -1] >= 0) & (obs[:, :, -1] <= 1)).all(),
                        f"{label}: tracked column")
            require(launches == expect,
                    f"{label}: launches {launches}, expected {expect}")
            for k, v in launches.items():
                record[k]["launches"] += v
            del scan

        mark("8^4 scans")

        # the scan from the command line, then resumed; the resumed scan's
        # series (scan.json) and links (scan_state.npz) equal an
        # uninterrupted scan's
        scan_cli = SimConfig(dims=SCAN_DIMS, n_or=2, sweeps_therm=10,
                             sweeps=10)
        with tempfile.TemporaryDirectory() as tmp:
            a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
            # warmup 1 + 1 sweeps, thermalize 10 and run 10 sweeps 0-19
            # (reunitarized after 9 and 19); resume's warmup and run 10
            # sweeps 20-29 (after 29)
            cli_launches("scan", ["scan", "--dims", "24,24,24,6", "--n-or",
                                  "2", "--betas", SCAN_GRID, "--therm", "10",
                                  "--sweeps", "10", "--out", a],
                         expected_chains(scan_cli, 22, 2, 11))
            cli_launches("scan --resume-state",
                         ["scan", "--resume-state",
                          os.path.join(a, "scan_state.npz"), "--sweeps",
                          "10", "--out", b],
                         expected_chains(scan_cli, 12, 1, 11))
            with open(os.path.join(b, "scan.json")) as f:
                rec_b = json.load(f)
            _, _, _, u_b, idx_b = load_betascan(
                os.path.join(b, "scan_state.npz"))
        print(f"CLI scan timings {rec_b['timings']}; plq by beta "
              f"{[round(r['plq'], 5) for r in rec_b['scan']]}  [{smi}]")
        whole = BetaScan(scan_cli.replace(sweeps=20), scan_betas)
        whole.warmup().thermalize()
        obs = whole.run()
        same_series = all(
            np.array_equal(np.asarray(rec_b["series"][name], np.float32),
                           obs[:, 10:, k])
            for k, name in enumerate(whole.obs_names))
        same_links = np.array_equal(u_b, whole.u.cpu().numpy())
        print(f"CLI scan 10 + 10 sweeps, then --resume-state 10: series and "
              f"links bit-identical to an uninterrupted scan: "
              f"{same_series and same_links}")
        require(same_series and same_links and idx_b == 30,
                "CLI scan + resume differs from the uninterrupted scan")
        del whole
        mark("CLI scan + resume")

        # the scan on a mesh from the command line: --mesh MESH
        # --chain-mesh 2 (4 chains of 12^3 x 6), then --resume-state in one
        # block; series and links equal an uninterrupted scan's
        mesh_arg = ",".join(map(str, MESH))
        dims_arg = ",".join(map(str, CLI_MESH_DIMS))
        cli_mesh = scan_cli.replace(dims=CLI_MESH_DIMS, mesh=MESH)
        with tempfile.TemporaryDirectory() as tmp:
            a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
            cli_launches("scan --mesh --chain-mesh 2",
                         ["scan", "--dims", dims_arg, "--n-or", "2",
                          "--betas", CLI_MESH_GRID, "--mesh", mesh_arg,
                          "--chain-mesh", "2", "--therm", "10", "--sweeps",
                          "10", "--out", a],
                         expected_chains(cli_mesh, 22, 2, 11, 2))
            cli_launches("scan --resume-state --chain-mesh 1",
                         ["scan", "--resume-state",
                          os.path.join(a, "scan_state.npz"), "--chain-mesh",
                          "1", "--sweeps", "10", "--out", b],
                         expected_chains(cli_mesh, 12, 1, 11))
            with open(os.path.join(b, "scan.json")) as f:
                rec_b = json.load(f)
            _, _, _, u_b, idx_b = load_betascan(
                os.path.join(b, "scan_state.npz"))
        whole = BetaScan(cli_mesh.replace(sweeps=20),
                         cli._parse_betas(CLI_MESH_GRID), 2)
        whole.warmup().thermalize()
        obs = whole.run()
        same_series = all(
            np.array_equal(np.asarray(rec_b["series"][name], np.float32),
                           obs[:, 10:, k])
            for k, name in enumerate(whole.obs_names))
        same_links = np.array_equal(u_b, whole.u.cpu().numpy())
        print(f"CLI scan {CLI_MESH_DIMS} mesh {MESH} chain_mesh 2, 10 + 10 "
              f"sweeps, then --resume-state --chain-mesh 1 for 10: series "
              f"and links bit-identical to an uninterrupted scan: "
              f"{same_series and same_links}; timings {rec_b['timings']}  "
              f"[{smi}]")
        require(same_series and same_links and idx_b == 30
                and rec_b["config"]["mesh"] == list(MESH),
                "CLI scan on a mesh + resume differs from the uninterrupted "
                "scan")
        del whole
        mark("CLI scan on a mesh + resume")

    def gate(r):
        """Print a validate.py check's result and require it to pass."""
        sg = r.get("self_regression")
        print(f"{r['name']}: measured {r['measured']} +- {r['err']:.7f}; "
              f"literature {r['expected']} within {r['tolerance']:.2e}"
              + (f"; self-anchor {sg['anchor']}: |d| {sg['dev']:.2e} < "
                 f"{sg['tolerance']:.2e} ({sg['tolerance_bound']})"
                 if sg else "")
              + f"; pass {r['pass']}")
        require(r["pass"], f"{r['name']}: {r}")

    with Phase("6 physics"):
        # the port's validate.py: its anchors, windows and chains
        su3 = SimConfig(group=3, dims=(16,) * 4, beta=6.0, sweeps_therm=200,
                        sweeps=400)
        sim1, st = validate._run_chain(su3)
        print(f"SU(3) 16^4 beta=6.0 HB: <plq> = {st.mean:.7f} +- "
              f"{st.err:.7f} (tau_int {st.tau_int:.2f}); window "
              f"{validate.SU3_B60_PLQ} +- {validate.SU3_WINDOW}")
        require(abs(st.mean - validate.SU3_B60_PLQ) < validate.SU3_WINDOW,
                f"<plq> {st.mean}")
        simn, stn = validate._run_chain(su3.replace(mesh=MESH))
        same = all(torch.equal(x, y) for x, y in zip(sim1.us, simn.us))
        print(f"SU(3) 16^4 beta=6.0 HB, mesh {MESH}: <plq> = "
              f"{stn.mean:.7f} +- {stn.err:.7f}; |d mean| from unsharded "
              f"{abs(stn.mean - st.mean):.1e}; links bit-identical {same}")
        require(same and abs(stn.mean - st.mean) < 1e-7,
                f"mesh {MESH} 16^4 chain differs from the unsharded one")
        del sim1, simn

        # SU(3) HB + 1 OR with track_kp_exhaust, seed 7, and SU(2) HB, seed
        # 42: threefry, then the PRNGCL streams QCDGPU users run (ranlux3,
        # its default; ranmar on SU(2)), then hw (Philox)
        for mode in ("threefry", "prngcl:ranlux3", "hw"):
            gate(validate.check_su3(rng_mode=mode))
        for mode in ("threefry", "prngcl:ranmar", "hw"):
            gate(validate.check_su2(rng_mode=mode))

        # SU(2) Metropolis with track_acceptance: the literature window
        cfg = SimConfig(group=2, dims=(8,) * 4, beta=2.4,
                        algorithm="metropolis", track_acceptance=True,
                        sweeps_therm=500, sweeps=1000, seed=42)
        sim, st = validate._run_chain(cfg)
        lit = max(5 * st.err, validate.SU2_WINDOW)
        acc = sim.analysis()["acc_rate"].mean
        print(f"SU(2) 8^4 beta=2.4 Metropolis: <plq> = {st.mean:.7f} +- "
              f"{st.err:.7f} (tau_int {st.tau_int:.2f}); |d| from "
              f"{validate.SU2_B24_PLQ}: "
              f"{abs(st.mean - validate.SU2_B24_PLQ):.2e} (< {lit:.2e}); "
              f"acc_rate {acc:.4f}")
        require(abs(st.mean - validate.SU2_B24_PLQ) < lit,
                f"SU(2) Metropolis <plq> {st.mean}")
        require(0.0 < acc < 1.0, f"acc_rate {acc}")
        del sim

        # BASELINE config 3: deconfinement across beta_c(N_t = 6) on 24^3 x
        # 6, one two-chain BetaScan, threefry and hw; then on MESH in 2
        # chain blocks, which must give the unsharded <|P|> digits
        for mode in ("threefry", "hw"):
            flat = None
            for kw in ({}, dict(mesh=MESH, chain_mesh=2)):
                r = validate.check_deconfinement(rng_mode=mode, **kw)
                msg = (f"{r['name']}: <|P|> below "
                       f"{r['measured']['below']:.7f}, above "
                       f"{r['measured']['above']:.7f} ({r['expected']}); "
                       f"pass {r['pass']}")
                print(msg)
                require(r["pass"], msg)
                if flat is None:
                    flat = r["measured"]
                    continue
                d = max(abs(r["measured"][k] - flat[k]) for k in flat)
                print(f"  |d| from the unsharded scan's <|P|>: {d:.1e} "
                      "(< 1e-6)")
                require(d < 1e-6, f"{r['name']}: differs from unsharded")

        # the PRNG self-test from the command line; the native host
        # generators must build here
        proc = subprocess.run(
            [sys.executable, "-m", "qcdgpu_tpu_torch", "rngtest"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True)
        print(proc.stdout.strip())
        require(proc.returncode == 0 and "unavailable" not in proc.stdout
                and all(f" {g} " in proc.stdout
                        for g in ("ranlux3", "xor128", "mrg32k3a", "ranmar")),
                f"rngtest exited {proc.returncode}: {proc.stderr[-2000:]}")

    with Phase("8 extended observables"):
        for k, v in extended_phase(dev, smi, counters).items():
            record[k]["launches"] += v

    with Phase("9 dense engine"):
        dense_phase(dev, smi, counters)

    idle = [k for k, r in record.items() if not r["launches"]]
    require(not idle, f"kernels no main path launched: {idle}")
    print(json.dumps({"kernels": list(record.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
