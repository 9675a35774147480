"""The packed engine: state layout, start states, sweeps and measurements.

Port of qcdgpu_tpu/ops/pallas/engine.py (threefry and the PRNGCL streams,
SU(2) and SU(3), every update algorithm, the tracked statistics).

The packed links are the reference's flat 8-tuple ``us[2*mu + parity]`` of
f32 tensors ``[2, N, 2, X, Y, Z*T/2]`` (see core.py for the layout), the
stream state ``rst`` is described below (``{}`` with threefry).  The sweep
and the runner work on the shards of cfg.mesh (sharded.py, parallel/
mesh.py): engine state is ``(shards, rst)``, one halo-padded 8-tuple per
shard and each parity's words split the same way; without a mesh it is one
shard without halo, the whole lattice.  A sweep
is one pass of cfg.algorithm and cfg.n_or overrelaxation passes, each 8
stages (parity 0, 1 x mu 0..3); stage ids run on across the passes, and
each stage is keyed ``rng.stage_key(base, sweep, stage_id)``.  On every
reunit_every-th sweep the 8 arrays are reunitarized.  Stages and
reunitarization update the links IN PLACE; a runner returns the same
tensors it was given.

With ``rng_mode="prngcl:<gen>"`` rst is the reference's packed stream
state, ``{"words_e", "words_o"}`` (each parity's per-site generator words
``[W, X, Y, Z*T/2]``) plus, for the lag generators, ``nb_e/nb_o``
(ranlux) or ``c_e/c_o`` (ranmar) and ``ptr_e/ptr_o`` as host Python
numbers.  This is the reference's Pallas
provenance: a drawing stage advances only its active parity's streams, and
overrelaxation draws nothing; the dense XLA provenance, which draws for
every site, is a different chain (M11).

Every kernel wrapper dispatches on the tensors' device (CPU: plain PyTorch
version; CUDA: the hand-written kernel), so the same sweep serves both.
Entry points run on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from ...config import SimConfig
from ...parallel.mesh import shard_grid
from .. import prng_streams as streams
from .. import rng, sun
from . import core
from . import measure as cmeasure
from . import sharded
from . import update as cupdate
from .reunit import reunitarize_dir

NDIM = 4
# stage-id namespace of the hot start (the reference's sim._STAGE_INIT)
STAGE_INIT = 0xF0


def resolve_device(device="cuda") -> torch.device:
    """torch.device for 'cpu' or 'cuda[:i]'; raises for a CUDA device when
    no card is present (no silent fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r}, but CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    return dev


def check_supported(cfg: SimConfig) -> None:
    """Raise NotImplementedError for configuration values the port does not
    run yet, naming the ROADMAP item that brings them."""
    todo = []
    if cfg.get_fmunu or cfg.wilson_loops or cfg.get_qtop:
        todo.append("get_fmunu / wilson_loops / get_qtop (M12)")
    if cfg.rng_mode == "hw":
        todo.append("rng_mode='hw' (M9, Philox)")
    if cfg.mesh[2] != 1 or cfg.mesh[3] != 1:
        # the reference runs Z/T meshes on its XLA engine (sim.py:273-285)
        todo.append(f"mesh={tuple(cfg.mesh)} splits Z/T (M11, dense "
                    "engine)")
    if cfg.dtype != "complex64" or cfg.meas_dtype != "same":
        todo.append("dtype='complex128' / meas_dtype='double' (M11)")
    if cfg.engine == "xla":
        todo.append("engine='xla' (M11, dense engine)")
    if todo:
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): " + "; ".join(todo)
        )


# ---------------------------------------------------------------------------
# layout conversion
# ---------------------------------------------------------------------------


def _sigma(dims, device):
    """(x+y+z) % 2 over [X, Y, Z, 1]."""
    x, y, z, _ = dims
    g = (torch.arange(x, device=device).reshape(x, 1, 1, 1)
         + torch.arange(y, device=device).reshape(1, y, 1, 1)
         + torch.arange(z, device=device).reshape(1, 1, z, 1))
    return g % 2


def split_links(u):
    """Complex [4, N, N, X, Y, Z, T] -> 8-tuple us[2*mu+p] of
    [2, N, 2, X, Y, Z*T/2] f32 (packed, two-row codec)."""
    dims = tuple(u.shape[3:])
    x, y, z, t = dims
    sig = _sigma(dims, u.device)
    out = []
    for mu in range(NDIM):
        m = u[mu][:2]
        s = torch.stack([m.real, m.imag], dim=2).to(torch.float32)
        even, odd = s[..., 0::2], s[..., 1::2]
        for p in range(2):
            pk = torch.where((sig + p) % 2 == 0, even, odd)
            out.append(pk.reshape(pk.shape[:3] + (x, y, z * (t // 2)))
                       .contiguous())
    return tuple(out)


def join_dir(pk_pair, dims, n):
    """(us[2mu], us[2mu+1]) back to complex64 [N, N, X, Y, Z, T]."""
    x, y, z, t = dims
    t2 = t // 2
    sig = _sigma(dims, pk_pair[0].device)
    dense = []
    for p in (0, 1):
        s = pk_pair[p].reshape(2, n, 2, x, y, z, t2)
        dense.append(torch.complex(s[:, :, 0], s[:, :, 1]))
    even = torch.where(sig == 0, dense[0], dense[1])
    odd = torch.where(sig == 0, dense[1], dense[0])
    inter = torch.stack([even, odd], dim=-1).reshape(2, n, x, y, z, t)
    if n == 3:
        # row 2 through the kernels' real-pair codec (core._codec_rows),
        # not torch's complex product, which may fuse multiply-adds
        rows = [tuple((c.real, c.imag) for c in inter[r]) for r in range(2)]
        r2 = core._codec_rows(rows, 3)[2]
        inter = torch.cat([inter, torch.stack(
            [torch.complex(re, im) for re, im in r2])[None]], dim=0)
    return inter


def split_site_field(v, dims):
    """Per-site field [..., X, Y, Z, T] -> (even, odd) [..., X, Y, Z*T/2],
    by split_links' T-slot rule (parity p keeps the t with
    (p + x + y + z + t) even at slot t // 2): the stream words' layout."""
    x, y, z, t = dims
    sig = _sigma(dims, v.device)
    even, odd = v[..., 0::2], v[..., 1::2]
    return tuple(
        torch.where((sig + p) % 2 == 0, even, odd)
        .reshape(v.shape[:-4] + (x, y, z * (t // 2))).contiguous()
        for p in range(2))


def join_site_field(pair, dims):
    """Inverse of split_site_field."""
    x, y, z, t = dims
    sig = _sigma(dims, pair[0].device)
    lead = pair[0].shape[:-3]
    a = pair[0].reshape(lead + (x, y, z, t // 2))
    b = pair[1].reshape(lead + (x, y, z, t // 2))
    even = torch.where(sig == 0, a, b)
    odd = torch.where(sig == 0, b, a)
    return torch.stack([even, odd], dim=-1).reshape(lead + (x, y, z, t))


def join_links(us, dims):
    n = us[0].shape[1]
    return torch.stack(
        [join_dir((us[2 * mu], us[2 * mu + 1]), dims, n) for mu in range(NDIM)]
    )


def from_reference(arrays, device="cuda"):
    """The JAX package's state, as numpy, -> the port's 8-tuple on device.

    Takes either the canonical complex field [4, N, N, X, Y, Z, T] (packed
    here through split_links) or the JAX engine's packed 8-tuple of f32
    arrays (adopted as is), SU(2) or SU(3)."""
    dev = resolve_device(device)
    if isinstance(arrays, (tuple, list)):
        if len(arrays) != 2 * NDIM:
            raise ValueError("a packed state is an 8-tuple us[2*mu+parity]")
        return tuple(
            torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)
            for a in arrays
        )
    a = np.asarray(arrays)
    if a.ndim != 7 or a.shape[0] != NDIM or not np.iscomplexobj(a):
        raise ValueError(
            f"expected complex [4, N, N, X, Y, Z, T], got {a.dtype} {a.shape}"
        )
    u = torch.from_numpy(np.array(a, dtype=np.complex64)).to(dev)
    return split_links(u)


# ---------------------------------------------------------------------------
# packed-direct start constructors
# ---------------------------------------------------------------------------


def packed_cold_start(cfg: SimConfig, device="cuda", shard=None):
    """Unit links in the engine layout (8 separate tensors: the stages
    update them in place); with ``shard`` (a core.Shard) its padded
    arrays."""
    dev = resolve_device(device)
    n = cfg.group
    x, y, z, t = cfg.dims if shard is None else shard.padded
    eye = torch.zeros((2, n, 2, 1, 1, 1), dtype=torch.float32, device=dev)
    eye[0, 0, 0] = 1.0
    eye[1, 1, 0] = 1.0
    shape = (2, n, 2, x, y, z * (t // 2))
    return tuple(eye.expand(shape).contiguous() for _ in range(2 * NDIM))


def packed_hot_start(cfg: SimConfig, base_key, device="cuda", shard=None):
    """Disordered (exactly Haar) start in the engine layout: the reference's
    per-site threefry normals, keyed by the global dense site index, and
    the same per-site Gram–Schmidt, one (mu, parity) array at a time.
    With ``shard`` (a core.Shard): its padded arrays, halos included, built
    from global coordinates (the global field is never built)."""
    dev = resolve_device(device)
    n = cfg.group
    dims = tuple(cfg.dims)
    key2 = rng.stage_key(base_key, 0, STAGE_INIT)
    out = []
    for mu in range(NDIM):
        kmu = rng.stage_key(key2, mu, STAGE_INIT + 1)
        for p in range(2):
            sidx = (core.site_index_packed(p, dims, dev) if shard is None
                    else core.site_index_padded(p, shard, dev))
            zn = rng.site_normals(kmu, sidx, 2 * n * n, slot0=0)
            re = zn[0: 2 * n * n: 2].reshape((n, n) + tuple(sidx.shape))
            im = zn[1: 2 * n * n: 2].reshape((n, n) + tuple(sidx.shape))
            m = sun.reunitarize(torch.complex(re, im))[:2]
            out.append(torch.stack([m.real, m.imag], dim=2)
                       .to(torch.float32).contiguous())
    return tuple(out)


def pack_stream_state(gen, dense, dims):
    """Dense stream state -> the packed state: each parity's words, and for
    the lag generators the scalars once per parity (equal at packing time;
    they diverge through each parity's own draws)."""
    we, wo = split_site_field(streams.state_to_words(gen, dense), dims)
    out = {"words_e": we, "words_o": wo}
    for k, v in streams.stream_kernel_scalars(gen, dense).items():
        out[k + "_e"] = v
        out[k + "_o"] = v
    return out


def make_stream_state0(cfg: SimConfig, device="cuda"):
    """The packed stream state of a fresh run, seeded from cfg.seed ({}
    with threefry)."""
    gen = streams.stream_mode_name(cfg.rng_mode)
    if gen is None:
        return {}
    dense = streams.make_stream_state(gen, cfg.seed, cfg.dims,
                                      resolve_device(device))
    return pack_stream_state(gen, dense, tuple(cfg.dims))


def packed_stream_hot_start(cfg: SimConfig, device="cuda"):
    """(us, rst): the hot start drawn from the streams in the dense layout
    (reference sim.stream_hot_start: per direction 2 N^2 draws, open01,
    Box–Muller with re = the first N^2 normals, reunitarize), then packed.
    The first sweep continues the same streams."""
    dev = resolve_device(device)
    gen = streams.stream_mode_name(cfg.rng_mode)
    n, dims = cfg.group, tuple(cfg.dims)
    st = streams.make_stream_state(gen, cfg.seed, dims, dev)
    links = []
    for _ in range(NDIM):
        uu, st = streams.stream_draw(gen, st, 2 * n * n)
        z = rng.normals_from_uniforms(streams.open01(uu))
        re = z[: n * n].reshape((n, n) + dims)
        im = z[n * n:].reshape((n, n) + dims)
        links.append(sun.reunitarize(torch.complex(re, im)))
    return split_links(torch.stack(links)), pack_stream_state(gen, st, dims)


def clone_state(st):
    """A copy of engine state (shards, rst), whose links and words are
    per-shard tuples, that the in-place kernels cannot touch."""
    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, tuple):
            return tuple(copy(a) for a in v)
        return v

    us, rst = st
    return copy(us), {k: copy(v) for k, v in rst.items()}


# ---------------------------------------------------------------------------
# sweep / measurement on packed state
# ---------------------------------------------------------------------------


def tracks(cfg: SimConfig) -> bool:
    """Whether the sweep accumulates a tracked statistic."""
    return bool(cfg.track_acceptance or cfg.track_kp_exhaust)


def tracked_stat_denom(cfg: SimConfig, dims) -> float:
    """Denominator of the per-sweep tracked statistic (reference
    ops/pallas/update.py:429-452), rounded to f32 as the reference rounds
    it: KP attempts, 8 stages x vol/2 ACTIVE sites x subgroups
    (track_kp_exhaust), or Metropolis trials, the same times n_hit
    (track_acceptance); 1 when the algorithm has no such stages."""
    vol2 = dims[0] * dims[1] * dims[2] * dims[3] // 2
    n_sg = len(cupdate.SUBGROUPS[cfg.group])
    if cfg.track_kp_exhaust:
        stages = 8 if cfg.algorithm == "heatbath" else 0
        return float(np.float32(max(stages * vol2 * n_sg, 1)))
    stages = 8 if cfg.algorithm == "metropolis" else 0
    return float(np.float32(max(stages * vol2 * cfg.n_hit * n_sg, 1)))


def stage_schedule(cfg: SimConfig):
    """The stages of one sweep in order, as (kind, parity, mu, stage_id,
    counted): cfg.algorithm, then cfg.n_or overrelaxation passes, each 8
    stages (parity 0, 1 x mu 0..3), stage ids running on across the
    passes; ``counted`` marks the stages whose tracked count the sweep
    keeps (reference ops/pallas/engine.py make_pallas_sweep)."""
    kinds = [cfg.algorithm] + ["overrelax"] * cfg.n_or
    track_kind = "heatbath" if cfg.track_kp_exhaust else "metropolis"
    return [(kind, parity, mu, 8 * i + 4 * parity + mu,
             tracks(cfg) and kind == track_kind)
            for i, kind in enumerate(kinds) for parity in (0, 1)
            for mu in range(NDIM)]


def stage_key2(cfg: SimConfig, kind, base_key, sweep_idx, stage_id):
    """The threefry key of a stage, or None where the stage draws nothing
    from threefry (overrelaxation: (0, 0), unused; a stream stage)."""
    if kind == "overrelax":
        return (0, 0)
    if streams.stream_mode_name(cfg.rng_mode):
        return None
    return rng.stage_key(base_key, sweep_idx, stage_id)


def reunit_due(cfg: SimConfig, sweep_idx) -> bool:
    """Whether sweep ``sweep_idx`` ends with reunitarization."""
    return (cfg.reunit_every > 0
            and sweep_idx % cfg.reunit_every == cfg.reunit_every - 1)


def make_sweep(cfg: SimConfig, grid):
    """sweep(state, base_key, sweep_idx) -> state, in place on the shards of
    ``grid`` (parallel/mesh.py ShardGrid); with tracking (``tracks(cfg)``)
    -> (state, rate), rate an f32 0-d tensor on the first shard's device:
    the sweep's tracked count over the GLOBAL ``tracked_stat_denom``.
    state is (shards, rst) as ``sharded.shard_state`` makes it; rst is
    returned as a new dict (its words advance in place, its scalars are
    replaced).  Stages follow ``stage_schedule``; each runs on every shard
    (K1 on a shard without halo, K1a on a padded one), then the halos of the
    array it wrote are refreshed.  The stream scalars advance once per
    stage, not once per shard: every shard starts the stage from the same
    ones and every site draws the same count.  The reunit condition is the
    reference's."""
    dims = tuple(cfg.dims)
    tracking = tracks(cfg)
    denom = tracked_stat_denom(cfg, dims)
    gen = streams.stream_mode_name(cfg.rng_mode)
    scalar_names = streams.kernel_scalar_names(gen) if gen else ()
    schedule = stage_schedule(cfg)
    devices = list(dict.fromkeys(grid.devices))
    # the halo views of the last state swept (the sweeps of a run update
    # the same tensors in place)
    last = {"shards": None, "plan": None}

    def sweep(state, base_key, sweep_idx):
        shards, rst = state[0], dict(state[1])
        if last["shards"] is not shards:
            last.update(shards=shards,
                        plan=sharded.halo_copies(shards, grid))
        counts = ({d: torch.zeros(1, dtype=torch.int64, device=d)
                   for d in devices} if tracking else None)
        for kind, parity, mu, stage_id, counted in schedule:
            sfx = ("_e", "_o")[parity]
            key2 = stage_key2(cfg, kind, base_key, sweep_idx, stage_id)
            draws = bool(gen) and kind != "overrelax"
            scal = {k: rst[k + sfx] for k in scalar_names}
            for s, (g, us) in enumerate(zip(grid.shards, shards)):
                src = {}
                if draws:
                    src = dict(gen=gen, words=rst["words" + sfx][s],
                               scalars=dict(scal))
                cupdate.stage_update(
                    us, mu, parity, cfg.beta, key2, dims, cfg.kp_trials,
                    kind=kind, n_hit=cfg.n_hit, metro_delta=cfg.metro_delta,
                    count=counts[grid.devices[s]] if counted else None,
                    shard=g, **src)
            if draws:
                rst.update({k + sfx: v for k, v in src["scalars"].items()})
            sharded.refresh_halos(shards, grid, (2 * mu + parity,),
                                  last["plan"])
        if reunit_due(cfg, sweep_idx):
            # K2 over each padded array whole: a halo slot holds its
            # owner's bits and comes out with the owner's new ones
            for g, us in zip(grid.shards, shards):
                for a in us:
                    reunitarize_dir(a, g.padded)
        if tracking:
            total = counts[devices[0]]
            for d in devices[1:]:
                total = total + counts[d].to(devices[0])
            return (shards, rst), total[0].to(torch.float32) / denom
        return shards, rst

    return sweep


def obs_base_from_sums(sums, poly, n, dims):
    """The standard 6-observable vector (f32) from the global f64 plane sums
    [6] and Polyakov sums [2]; normalised in f64."""
    vol = dims[0] * dims[1] * dims[2] * dims[3]
    s = sums / (n * vol)
    # PLANES order: (0,1),(0,2),(0,3),(1,2),(1,3),(2,3); temporal = nu == 3
    plq_s = (s[0] + s[1] + s[3]) / 3.0
    plq_t = (s[2] + s[4] + s[5]) / 3.0
    plq = 0.5 * (plq_s + plq_t)
    pl = poly / (n * (vol // dims[3]))
    return torch.stack([plq, plq_s, plq_t, 1.0 - plq, pl[0], pl[1]]
                       ).to(torch.float32)


def measure_shards(shards, geoms):
    """Observable vector (ops.measure.OBS_NAMES) of the lattice that the
    shards cover (``geoms``: their core.Shard geometries): K3/K4 on a shard
    without halo, K5a/K5b on a padded one, the f64 sums added in shard
    order on the first shard's device; deterministic run to run."""
    dev = shards[0][0].device
    sums = poly = None
    for g, us in zip(geoms, shards):
        s = cmeasure.plane_sums_local(us, g).to(dev)
        p = cmeasure.polyakov_sums_local(us, g).to(dev)
        sums = s if sums is None else sums + s
        poly = p if poly is None else poly + p
    return obs_base_from_sums(sums, poly, shards[0][0].shape[1],
                              tuple(geoms[0].dims))


def measure_all_split(us, dims):
    """Observable vector of one unsharded packed 8-tuple; stays on its
    device."""
    return measure_shards((us,), (core.whole(dims),))


def make_chunk_runner(cfg: SimConfig, device="cuda", devices=None):
    """Runner for the packed engine (the contract of the reference's
    make_pallas_chunk_runner): run(u, key, sweep0, n, me), run.packed on
    engine state, run.pack / run.unpack (run.pack gives fresh streams from
    cfg.seed in stream mode), run.packed_cold_start, run.packed_hot_start,
    run.measure_packed, run.make_stream_state0 and, in stream mode,
    run.packed_stream_hot_start; run.scatter / run.gather between the
    global packed state and the runner's; run.grid.

    Engine state is (shards, rst): one 8-tuple per shard of cfg.mesh
    (parallel/mesh.py), halo-padded on a split axis, and rst with each
    parity's words split the same way (sharded.shard_state).  Without a
    mesh the grid is one shard without halo, which is the whole lattice.
    The shards sit on ``device`` unless ``devices`` lists the devices to
    spread them over.

    The threefry starts build each shard from global coordinates, so the
    global field is never built (the reference's out_shardings rule,
    ops/pallas/sharded.py:302-312).  The stream starts build the global
    stream state on ``device`` and split it."""
    from ...runner import build_chunk_runner

    check_supported(cfg)
    dev = resolve_device(device)
    grid = shard_grid(cfg, dev, None if devices is None
                      else [resolve_device(d) for d in devices])
    gen = streams.stream_mode_name(cfg.rng_mode)
    dims = tuple(cfg.dims)

    def meas(shards):
        return measure_shards(shards, grid.shards)

    run = build_chunk_runner(
        cfg, make_sweep(cfg, grid), lambda st: meas(st[0]),
        pack=lambda u: sharded.shard_state(
            (split_links(u.to(dev)), make_stream_state0(cfg, dev)), grid),
        unpack=lambda st: join_links(sharded.gather_links(st[0], grid), dims),
        with_acc=tracks(cfg), device=grid.devices[0],
    )
    run.grid = grid
    run.scatter = lambda us: sharded.shard_links(us, grid)
    run.gather = lambda st: sharded.gather_state(st, grid)
    run.packed_cold_start = lambda: tuple(
        packed_cold_start(cfg, d, g) for g, d in zip(grid.shards,
                                                     grid.devices))
    run.packed_hot_start = lambda key: tuple(
        packed_hot_start(cfg, key, d, g) for g, d in zip(grid.shards,
                                                        grid.devices))
    run.measure_packed = meas
    run.make_stream_state0 = lambda: sharded.shard_streams(
        make_stream_state0(cfg, dev), grid)
    if gen:
        run.packed_stream_hot_start = lambda: sharded.shard_state(
            packed_stream_hot_start(cfg, dev), grid)
    return run
