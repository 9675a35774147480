"""The dense engine: the whole-lattice, masked checkerboard Monte Carlo.

Port of the reference's XLA engine (qcdgpu_tpu/sim.py:55-284 and the XLA
branch of make_chunk_runner, :326-373) as PyTorch ops, on one device or
over a 4D mesh of shards:

    cold_start / hot_start / stream_hot_start   start states
    make_sweep_fn(cfg, with_acc, grid)           the sweep (threefry, stream)
    make_chunk_runner(cfg, device, devices)      the runner Simulation drives

config.resolve_engine picks this engine ("xla") or the packed one.

The state is the complex field ``u`` [4, N, N, X, Y, Z, T] in cfg.dtype
(complex64, or complex128: a real f64 chain, on the card too) and, with
``rng_mode="prngcl:<gen>"``, the dense stream state (ops/prng_streams.py
``make_stream_state``: the reference's keys, one array a word over the
lattice).  A sweep is one pass of cfg.algorithm and cfg.n_or
overrelaxation passes, each 8 stages (parity 0, 1 x mu 0..3): a stage takes
the staple sum of its direction over the whole lattice
(ops/staples.py), updates every link (ops/samplers.py) and keeps the
new links of its parity.  Threefry keys stage ``s`` of sweep ``k`` by
``rng.stage_key(base, k, s)`` and the global dense site index; a stream
stage draws ``stage_uniform_count`` words at EVERY site (overrelaxation
draws none).  That is the reference's dense provenance, another chain than
the packed engine's (which draws at the active parity's sites only), so
their stream checkpoints are refused across engines.

On a mesh (cfg.mesh, any of the four axes split; the reference's SPMD XLA
engine over parallel/mesh.py:30-58) the field and the stream words are
cut into the shards of a DenseGrid (parallel/mesh.py), each field
halo-padded on its split axes (dense_sharded.py): a stage computes the
staples on each padded shard, updates its interior with the interior's
global site keys or its own words, and refreshes the halos of the
direction it wrote; the standard observables are summed shard by shard.
The sharded chain is the unsharded one bit for bit.  Without a mesh the
grid is one shard without halo, the whole lattice.

There is no hand-written kernel on this path: the reference's dense engine
is XLA ops, and its counterpart here is PyTorch ops, on the card unless
the caller passes device="cpu".  The stages write the links in place,
op by op.

A beta scan runs C chains as one batched sweep (the reference's vmap,
models/ensemble.py:132-144): the field is [4, N, N, C, X, Y, Z, T], the
chain axis before the lattice axes, with a coupling and a key per chain
(``make_sweep_fn`` with ``beta`` a sequence and ``base_key`` a list) and
the stream words [..., C, X, Y, Z, T]; every operation is elementwise over
the chains, so chain c's links are its single-chain sweep's bit for bit.
The lattice axes are the last four on a mesh too, so a block of chains
shares its shards.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .config import SimConfig, stream_mode_name
from .ops import prng_streams as streams
from .ops import rng, sun
from .ops.cuda import engine
from . import dense_sharded as dsh
from .ops.lattice import site_index
from .ops.samplers import (stage_uniform_count, tracked_rate,
                           two_beta_over_n, update_links)
from .ops.staples import staple_sum
from .parallel.mesh import DenseGrid, dense_grid

NDIM = 4
STAGE_INIT = engine.STAGE_INIT
CHAIN_AXIS = -5  # a scan's chain axis in a per-direction field or a word


def cdtype(cfg: SimConfig) -> torch.dtype:
    return torch.complex128 if cfg.dtype == "complex128" else torch.complex64


# ---------------------------------------------------------------------------
# start states
# ---------------------------------------------------------------------------


def cold_start(cfg: SimConfig, device="cuda"):
    """Unit links [4, N, N, X, Y, Z, T] in cfg.dtype."""
    dev = engine.resolve_device(device)
    n = cfg.group
    eye = sun.identity(n, tuple(cfg.dims), cdtype(cfg), dev)
    return eye[None].expand((NDIM,) + tuple(eye.shape)).contiguous()


def hot_start(cfg: SimConfig, base_key, device="cuda"):
    """Disordered, exactly Haar start: per link 2 N^2 threefry normals
    keyed by the global dense site index (the reference's hot_start, the
    packed engine's packed_hot_start site for site), a Ginibre matrix in
    cfg.dtype, reunitarized in that dtype."""
    dev = engine.resolve_device(device)
    n, dims = cfg.group, tuple(cfg.dims)
    key2 = rng.stage_key(base_key, 0, STAGE_INIT)
    sidx = site_index(dims, dev)
    links = []
    for mu in range(NDIM):
        kmu = rng.stage_key(key2, mu, STAGE_INIT + 1)
        z = rng.site_normals(kmu, sidx, 2 * n * n, slot0=0)
        re = z[0: 2 * n * n: 2].reshape((n, n) + dims)
        im = z[1: 2 * n * n: 2].reshape((n, n) + dims)
        links.append(sun.reunitarize(torch.complex(re, im).to(cdtype(cfg))))
    return torch.stack(links)


def stream_hot_start(cfg: SimConfig, rst):
    """(u, rst'): the hot start drawn from the dense stream state ``rst``
    (the reference's stream_hot_start): per direction 2 N^2 draws, open01,
    Box–Muller (re the first N^2 normals), reunitarized in cfg.dtype.  The
    first sweep continues the same streams."""
    gen = stream_mode_name(cfg.rng_mode)
    n, dims = cfg.group, tuple(cfg.dims)
    links = []
    for _ in range(NDIM):
        uu, rst = streams.stream_draw(gen, rst, 2 * n * n)
        z = rng.normals_from_uniforms(streams.open01(uu))
        re = z[: n * n].reshape((n, n) + dims)
        im = z[n * n:].reshape((n, n) + dims)
        links.append(sun.reunitarize(torch.complex(re, im).to(cdtype(cfg))))
    return torch.stack(links), rst


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------


def _stage_keys(base_key, sweep_idx, stage_id, device):
    """The stage key: two ints, or with a list of per-chain base keys two
    int64 tensors [C, 1, 1, 1, 1] (one key per chain)."""
    if isinstance(base_key, list):
        ks = np.array([rng.stage_key(k, sweep_idx, stage_id)
                       for k in base_key], np.int64)
        return tuple(torch.from_numpy(ks[:, i].reshape(-1, 1, 1, 1, 1))
                     .to(device) for i in (0, 1))
    return rng.stage_key(base_key, sweep_idx, stage_id)


def make_sweep_fn(cfg: SimConfig, with_acc: bool = False, grid=None):
    """sweep(u, base_key, sweep_idx, beta=None) -> u for threefry (and
    rng_mode "hw", which the dense engine draws as threefry), or, with
    rng_mode="prngcl:<gen>", stream_sweep((u, rst), base_key, sweep_idx,
    beta=None) -> (u, rst'); with with_acc each returns (state, rate), the
    sweep's tracked statistic: the mean Metropolis acceptance
    (track_acceptance) or KP trial exhaustion (track_kp_exhaust) of the
    tracked stages (qcdgpu_tpu/sim.py:122-232).

    u is updated IN PLACE (and returned).  beta=None takes cfg.beta; a
    beta scan passes one coupling per chain and base_key as a list of the
    chains' keys, with u [4, N, N, C, X, Y, Z, T].

    grid: a parallel.mesh DenseGrid.  u is then the tuple of its shards'
    padded fields and rst the sharded stream state (dense_sharded.py); a
    stage updates each shard's interior, then refreshes the halos of the
    direction it wrote, and the tracked counts of the shards are added
    before they are divided, so every link, word and rate is the
    unsharded sweep's.  Without a grid u is one field, the whole
    lattice."""
    dims = tuple(cfg.dims)
    # the whole lattice as one shard (its device is unused: every stage
    # runs where its tensors lie)
    grid = grid or DenseGrid(dims, (1,) * NDIM, ["cpu"])
    vol = int(np.prod(dims))
    kinds = [cfg.algorithm] + ["overrelax"] * cfg.n_or
    gen = stream_mode_name(cfg.rng_mode)
    track_kind = "heatbath" if cfg.track_kp_exhaust else "metropolis"
    n_sg = len(sun.subgroups(cfg.group))
    geom = {}
    couplings = {}
    # the halo views of the last shards swept (a run's sweeps update the
    # same tensors in place)
    last = {"shards": None, "plan": None}

    def lattice(k, device):
        if (k, device) not in geom:
            geom[(k, device)] = dsh.site_geometry(grid.shards[k], device)
        return geom[(k, device)]

    def two_beta(b, device):
        # 2 beta / N on the device, made once for a coupling (or the
        # couplings of a scan: a [C, 1, 1, 1, 1] tensor, so the key holds
        # the rank)
        bb = np.asarray(b, np.float64)
        k = (device, bb.ndim, tuple(bb.ravel()))
        if k not in couplings:
            couplings[k] = two_beta_over_n(b, cfg.group, device)
        return couplings[k]

    def stage(shards, randomness, parity, mu, kind, beta):
        # randomness: the stage key (base key, sweep, stage id), or the
        # pre-drawn uniforms of a stream, one tensor a shard (None for
        # overrelaxation)
        track = with_acc and kind == track_kind
        b = cfg.beta if beta is None else beta
        counts = None
        keys = {}
        for k, (g, u) in enumerate(zip(grid.shards, shards)):
            sidx, masks = lattice(k, u.device)
            kw = dict(k_trials=cfg.kp_trials, n_hit=cfg.n_hit,
                      metro_delta=cfg.metro_delta, return_acc=track,
                      two_beta=two_beta(b, u.device))
            a = g.interior(staple_sum(u, mu))
            old = g.interior(u[mu])
            if gen is None:
                if u.device not in keys:
                    keys[u.device] = _stage_keys(*randomness, u.device)
                new = update_links(old, a, kind, b, keys[u.device], sidx,
                                   **kw)
            else:
                new = update_links(old, a, kind, b, None, None,
                                   uniforms=randomness and randomness[k],
                                   **kw)
            if track:
                new, cnt = new
                cnt = [c.to(shards[0].device) for c in cnt]
                counts = cnt if counts is None else [
                    x + y for x, y in zip(counts, cnt)]
            old.copy_(torch.where(masks[parity], new, old))
        if last["plan"]:
            dsh.refresh(last["plan"], mu)
        if counts is None:
            return None
        return tracked_rate(counts, vol, kind, cfg.n_hit, n_sg)

    def begin(shards):
        if last["shards"] is not shards:
            last.update(shards=shards, plan=dsh.halo_plan(shards, grid)
                        if len(grid) > 1 else None)

    def finish(shards, sweep_idx):
        # per site, on the padded fields whole: a halo site holds its
        # owner's bits and comes out with the owner's new ones
        if (cfg.reunit_every > 0
                and sweep_idx % cfg.reunit_every == cfg.reunit_every - 1):
            for u in shards:
                for m in range(NDIM):
                    u[m] = sun.reunitarize(u[m])

    def result(state, acc_sum, acc_n):
        # with_acc: cfg tracks its algorithm's own kind, so acc_n > 0
        return (state, acc_sum / acc_n) if with_acc else state

    def sweep(u, base_key, sweep_idx, beta=None):
        shards = (u,) if isinstance(u, torch.Tensor) else u
        begin(shards)
        stage_id = 0
        acc_sum, acc_n = 0.0, 0
        for kind in kinds:
            for parity in (0, 1):
                for mu in range(NDIM):
                    acc = stage(shards, (base_key, sweep_idx, stage_id),
                                parity, mu, kind, beta)
                    if acc is not None:
                        acc_sum, acc_n = acc_sum + acc, acc_n + 1
                    stage_id += 1
        finish(shards, sweep_idx)
        return result(u, acc_sum, acc_n)

    if gen is None:
        return sweep
    n_upd = stage_uniform_count(cfg.group, cfg.algorithm, cfg.kp_trials,
                                cfg.n_hit)

    def stream_sweep(state, base_key, sweep_idx, beta=None):
        u, rst = state
        whole = isinstance(u, torch.Tensor)
        shards = (u,) if whole else u
        if whole:
            rst = {k: (v,) if isinstance(v, torch.Tensor) else v
                   for k, v in rst.items()}
        begin(shards)
        acc_sum, acc_n = 0.0, 0
        for kind in kinds:
            for parity in (0, 1):
                for mu in range(NDIM):
                    uu = None
                    if kind != "overrelax":
                        # every shard draws the same count from its own
                        # words; the scalars advance alike on each
                        drawn = [streams.stream_draw(
                            gen, dsh.shard_streams(rst, k), n_upd)
                            for k in range(len(shards))]
                        uu = [streams.open01(d[0]) for d in drawn]
                        rst = {n: tuple(d[1][n] for d in drawn)
                               if isinstance(rst[n], tuple) else
                               drawn[0][1][n] for n in rst}
                    acc = stage(shards, uu, parity, mu, kind, beta)
                    if acc is not None:
                        acc_sum, acc_n = acc_sum + acc, acc_n + 1
        finish(shards, sweep_idx)
        if whole:
            rst = dsh.shard_streams(rst, 0)
        return result((u, rst), acc_sum, acc_n)

    return stream_sweep


# ---------------------------------------------------------------------------
# the dense stream state at the host boundary
# ---------------------------------------------------------------------------

# the reference's dense state keys (make_stream_state_host), by family
_DENSE_KEYS = {
    "xor128": ("x", "y", "z", "w"), "xor7": ("x",),
    "mrg32k3a": ("s1", "s2"), "parkmiller": ("s",), "constant": ("v",),
    "ranlux": ("x", "carry", "nb"), "ranmar": ("u", "c"),
}
_U32_FAMILIES = ("xor128", "xor7", "mrg32k3a")


def dense_stream_keys(gen) -> frozenset:
    """Keys of generator ``gen``'s dense stream state (the reference's)."""
    return frozenset(_DENSE_KEYS[streams.family(gen)])


def stream_to_numpy(gen, rst) -> dict:
    """A dense stream state as numpy in the reference's dtypes: u32 words
    as uint32, the others as stored (int32, f32); nb int32, c f32 (0-d)."""
    u32 = streams.family(gen) in _U32_FAMILIES
    out = {}
    for k, v in rst.items():
        if isinstance(v, torch.Tensor):
            a = v.cpu().numpy()
            out[k] = a.view(np.uint32) if u32 else a
        elif k == "c":
            out[k] = np.float32(v)
        else:
            out[k] = np.int32(v)
    return out


def stream_from_numpy(gen, rst, dims, device) -> dict:
    """Inverse of stream_to_numpy onto ``device``; refuses a state whose
    keys are not the dense ones of ``gen`` (a packed engine's state: the
    reference's check, qcdgpu_tpu/sim.py:381-394) or whose words are not
    over ``dims`` (trailing axes)."""
    engine.check_stream_keys(set(rst), dense_stream_keys(gen))
    out = {}
    for k, v in rst.items():
        a = np.asarray(v)
        if a.ndim == 0:
            out[k] = float(a) if k == "c" else int(a)
            continue
        if tuple(a.shape[-4:]) != tuple(dims):
            raise ValueError(f"stream {k}: shape {a.shape}, expected the "
                             f"lattice {tuple(dims)} last")
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def field_from_input(arrays, cfg: SimConfig, device):
    """A given start state -> the dense field in cfg.dtype on ``device``:
    the canonical complex field (numpy, from either package, or a tensor)
    or a packed 8-tuple (numpy or tensors; joined)."""
    dev = engine.resolve_device(device)
    if isinstance(arrays, (tuple, list)):
        if all(isinstance(a, torch.Tensor) for a in arrays):
            us = tuple(a.to(dev, torch.float32).contiguous() for a in arrays)
        else:
            us = engine.from_reference(tuple(arrays), dev)
        u = engine.join_links(us, tuple(cfg.dims))
    elif isinstance(arrays, torch.Tensor):
        u = arrays.to(dev)
    else:
        a = np.asarray(arrays)
        if not np.iscomplexobj(a):
            raise ValueError(f"expected a complex field, got {a.dtype}")
        u = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    want = (NDIM, cfg.group, cfg.group) + tuple(cfg.dims)
    if tuple(u.shape) != want:
        raise ValueError(f"links of shape {tuple(u.shape)}, expected {want}")
    return u.to(cdtype(cfg)).contiguous().clone()


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------


def make_chunk_runner(cfg: SimConfig, device="cuda", devices=None):
    """The dense engine's runner, with the surface Simulation drives on the
    packed one (ops/cuda/engine.py make_chunk_runner): run(u, key, sweep0,
    n, me) and run.packed on state (shards, rst), run.pack / run.unpack,
    run.packed_cold_start, run.packed_hot_start(key),
    run.packed_stream_hot_start (stream mode), run.make_stream_state0,
    run.measure_packed, run.adopt (a given start state), run.adopt_streams
    / run.stream_to_numpy (the stream state at the host boundary),
    run.scatter / run.gather (between the global state and the shards'),
    run.grid and run.engine = "xla".

    The state is the shards of cfg.mesh's DenseGrid (parallel/mesh.py),
    each halo-padded on a split axis, and the sharded dense stream state
    ({} with threefry; dense_sharded.py).  Without a mesh the grid is one
    shard without halo, the whole lattice.  The shards sit on ``device``
    unless ``devices`` lists the devices to spread them over.  The starts
    are built whole on ``device`` and scattered (the reference's
    qcdgpu_tpu/sim.py:485-496)."""
    from .runner import build_chunk_runner

    dev = engine.resolve_device(device)
    if cfg.rng_mode == "hw":
        # the reference's words (qcdgpu_tpu/sim.py:326-338)
        warnings.warn(
            "rng_mode='hw' requested but the run resolved to the XLA "
            "engine, which always draws threefry streams; results are "
            "produced with rng_mode='threefry'",
            stacklevel=2,
        )
    grid = dense_grid(cfg, dev, None if devices is None
                      else [engine.resolve_device(d) for d in devices])
    gen = stream_mode_name(cfg.rng_mode)
    tracking = engine.tracks(cfg)
    sweep = make_sweep_fn(cfg, with_acc=tracking, grid=grid)
    meas = dsh.make_measure(cfg, grid)
    dims = tuple(cfg.dims)

    def streams0():
        if gen is None:
            return {}
        return streams.make_stream_state(gen, cfg.seed, dims, dev)

    def scatter(u):
        return dsh.scatter(u, grid)

    def state(u, rst):
        return scatter(u), dsh.scatter_streams(rst, grid)

    if gen is None:
        def step(st, key, sweep_idx):
            out = sweep(st[0], key, sweep_idx)
            if tracking:
                return (out[0], st[1]), out[1]
            return out, st[1]
    else:
        step = sweep

    run = build_chunk_runner(
        cfg, step, lambda st: meas(st[0]),
        pack=lambda u: state(field_from_input(u, cfg, dev), streams0()),
        unpack=lambda st: dsh.gather(st[0], grid, copy=True),
        with_acc=tracking, device=grid.devices[0])
    run.engine = "xla"
    run.grid = grid
    run.scatter = scatter
    run.gather = lambda st: (dsh.gather(st[0], grid),
                             dsh.gather_streams(st[1], grid))
    run.adopt = lambda arrays: scatter(field_from_input(arrays, cfg, dev))
    run.packed_cold_start = lambda: scatter(cold_start(cfg, dev))
    run.packed_hot_start = lambda key: scatter(hot_start(cfg, key, dev))
    run.measure_packed = meas
    run.make_stream_state0 = lambda: dsh.scatter_streams(streams0(), grid)
    run.stream_state_keys = dense_stream_keys(gen) if gen else frozenset()
    run.adopt_streams = lambda rst: dsh.scatter_streams(
        stream_from_numpy(gen, rst, dims, dev), grid)
    run.stream_to_numpy = lambda rst: stream_to_numpy(gen, rst)
    if gen is not None:
        run.packed_stream_hot_start = lambda: state(
            *stream_hot_start(cfg, streams0()))
    return run
