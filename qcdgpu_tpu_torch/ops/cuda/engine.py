"""The packed engine: state layout, start states, sweeps and measurements.

Port of qcdgpu_tpu/ops/pallas/engine.py (threefry, rng_mode "hw" as
Philox, and the PRNGCL streams; SU(2) and SU(3), every update algorithm,
the tracked statistics).

The packed links are the reference's flat 8-tuple ``us[2*mu + parity]`` of
f32 tensors ``[2, N, 2, X, Y, Z*T/2]`` (see core.py for the layout), the
stream state ``rst`` is described below (``{}`` with threefry).  The sweep
and the runner work on the shards of cfg.mesh (sharded.py, parallel/
mesh.py): engine state is ``(shards, rst)``, one halo-padded 8-tuple per
shard and each parity's words split the same way; without a mesh it is one
shard without halo, the whole lattice.  A sweep
is one pass of cfg.algorithm and cfg.n_or overrelaxation passes, each 8
stages (parity 0, 1 x mu 0..3); stage ids run on across the passes, and
each stage is keyed ``rng.stage_key(base, sweep, stage_id)``, which keys
threefry, or Philox with rng_mode "hw" (whose hot start is threefry's, as
in the reference, sim.py:467-473).  On every
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
every site, is a different chain.

The chain axis of a beta scan (models/ensemble.py; the reference's
Pallas chain tiers, qcdgpu_tpu/models/ensemble.py:96-131): each of the 8
arrays is chain-stacked, ``[C, 2, N, 2, X, Y, Z*T/2]`` (the reference's
``vmap(split_links)`` layout, so ``us[k][c]`` is chain c's array), and
``make_chain_sweep`` runs every stage as one K1c launch over all chains,
each chain with its own coupling and key; K2c reunitarizes and K3c/K4c
measure all chains at once.  On an X/Y mesh (the chain x lattice tier) a
block of chains is cut into the shards of its grid, each shard's arrays
chain-stacked and halo-padded: a stage is one K1ac launch per shard, then
the halo refresh of the array it wrote, and K5ac/K5bc measure; without a
mesh the grid is one shard without halo and this is K1c.  Chain c computes
what its single-chain sweep (sharded or not) computes on its own arrays,
bit for bit.

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
from ..measure import has_extended, measure_extended
from . import core
from . import measure as cmeasure
from . import sharded
from . import update as cupdate
from .reunit import reunitarize_chains, reunitarize_dir

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
    """Raise ValueError for what the packed engine cannot run: a dtype
    other than complex64 (its links are f32) and a mesh that splits Z or T
    (it shards X and Y only).

    meas_dtype="double" runs as on the reference's packed engine, where it
    means the wide sums that are always on: K3/K4 sum in f64 whatever it
    says, so the measurement is bit-identical to "same", and the extended
    observables are computed on the complex64 join."""
    if cfg.dtype != "complex64":
        raise ValueError(f"the packed engine is complex64 only, not "
                         f"dtype={cfg.dtype!r}")
    if cfg.mesh[2] != 1 or cfg.mesh[3] != 1:
        raise ValueError(f"the packed engine shards X and Y only, not "
                         f"mesh={tuple(cfg.mesh)}")


def check_stream_keys(have, want) -> None:
    """Refuse a stream state whose layout is not the resolved engine's, in
    the reference's words (qcdgpu_tpu/sim.py:381-394): the dense and the
    packed states are different randomness provenances."""
    if set(have) != set(want):
        raise ValueError(
            "PRNGCL stream-state layout mismatch: checkpoint has "
            f"{sorted(have)} but the resolved engine expects "
            f"{sorted(want)} — resume with the same engine "
            "(XLA dense vs Pallas packed states are different "
            "randomness provenances)"
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


def stream_state_keys(gen):
    """Keys of the packed stream state of generator ``gen``."""
    return frozenset(k + sfx for sfx in ("_e", "_o")
                     for k in ("words",) + streams.kernel_scalar_names(gen))


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


def links_from_input(arrays, device):
    """A given start state -> the unsharded packed 8-tuple on ``device``:
    a packed 8-tuple (tensors, copied; or numpy from either package) or
    the canonical complex field (a tensor, or numpy), split."""
    if isinstance(arrays, (tuple, list)):
        if all(isinstance(a, torch.Tensor) for a in arrays):
            return tuple(a.to(device, torch.float32).contiguous().clone()
                         for a in arrays)
        return from_reference(tuple(arrays), device)
    if isinstance(arrays, torch.Tensor):
        return split_links(arrays.to(device, torch.complex64))
    return from_reference(arrays, device)


def stream_state_from_numpy(gen, rst, dims, device):
    """A saved packed stream state (numpy, the reference's keys and dtypes)
    -> the unsharded packed state on ``device``; refuses another layout
    (check_stream_keys) or words of another shape."""
    check_stream_keys(set(rst), stream_state_keys(gen))
    shape = (streams.stream_word_count(gen), dims[0], dims[1],
             dims[2] * (dims[3] // 2))
    out = {}
    for k, v in rst.items():
        if k.startswith("words"):
            out[k] = streams.words_from_numpy(gen, v, device)
            if tuple(out[k].shape) != shape:
                raise ValueError(f"stream {k}: shape {tuple(v.shape)}, "
                                 f"expected {shape}")
        elif k.startswith("c_"):
            out[k] = float(v)
        else:
            out[k] = int(v)
    return out


def stream_state_to_numpy(gen, rst):
    """The unsharded packed stream state as numpy in the reference's dtypes
    (words uint32 / int32 / float32; nb, ptr int32; c float32)."""
    out = {}
    for k, v in rst.items():
        if isinstance(v, torch.Tensor):
            out[k] = streams.words_to_numpy(gen, v)
        elif k.startswith("c_"):
            out[k] = np.float32(v)
        else:
            out[k] = np.int32(v)
    return out


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
    """The counter-based key of a stage (threefry's, or Philox's with
    rng_mode "hw": the same stage key), or None where the stage draws from
    a stream ((0, 0), unused, for overrelaxation)."""
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
    counter = "threefry" if gen else cfg.rng_mode  # threefry or hw (Philox)
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
                    shard=g, rng_mode=counter, **src)
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
    [..., 6] and Polyakov sums [..., 2]; normalised in f64."""
    vol = dims[0] * dims[1] * dims[2] * dims[3]
    s = sums / (n * vol)
    # PLANES order: (0,1),(0,2),(0,3),(1,2),(1,3),(2,3); temporal = nu == 3.
    # Elementwise only over leading (chain) axes: a chain's row rounds as
    # the single chain's does.
    plq_s = (s[..., 0] + s[..., 1] + s[..., 3]) / 3.0
    plq_t = (s[..., 2] + s[..., 4] + s[..., 5]) / 3.0
    plq = 0.5 * (plq_s + plq_t)
    pl = poly / (n * (vol // dims[3]))
    return torch.stack([plq, plq_s, plq_t, 1.0 - plq, pl[..., 0],
                        pl[..., 1]], dim=-1).to(torch.float32)


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


def with_extended(base, joined, cfg):
    """``base`` (the standard six of one chain [6], or of a block [C, 6]),
    followed by cfg's extended columns (ops.measure.measure_extended) of
    the joined field of each row, which ``joined()`` yields one at a time;
    ``base`` alone when cfg asks for none."""
    if not has_extended(cfg):
        return base
    ext = torch.stack([measure_extended(u, cfg) for u in joined()])
    return torch.cat([base, ext.reshape(base.shape[:-1] + (-1,))], dim=-1)


def measure_all_split(us, dims, cfg=None):
    """Observable vector (ops.measure.measure_obs_names(cfg)) of one
    unsharded packed 8-tuple: the standard six from K3/K4, then cfg's
    extended columns on the joined field; stays on its device."""
    return with_extended(measure_shards((us,), (core.whole(dims),)),
                         lambda: [join_links(us, dims)], cfg)


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
    dims = tuple(cfg.dims)
    gen = streams.stream_mode_name(cfg.rng_mode)

    def meas(shards):
        # the extended columns on the global field, the shards gathered
        # and joined on the first shard's device (the reference's
        # ops/pallas/sharded.py:272-279)
        return with_extended(
            measure_shards(shards, grid.shards),
            lambda: [join_links(sharded.gather_links(shards, grid), dims)],
            cfg)

    run = build_chunk_runner(
        cfg, make_sweep(cfg, grid), lambda st: meas(st[0]),
        pack=lambda u: sharded.shard_state(
            (split_links(u.to(dev)), make_stream_state0(cfg, dev)), grid),
        unpack=lambda st: join_links(sharded.gather_links(st[0], grid), dims),
        with_acc=tracks(cfg), device=grid.devices[0],
    )
    run.engine = "pallas"
    run.grid = grid
    run.scatter = lambda us: sharded.shard_links(us, grid)
    run.adopt = lambda arrays: run.scatter(links_from_input(arrays, dev))
    run.stream_state_keys = stream_state_keys(gen) if gen else frozenset()
    run.adopt_streams = lambda rst: sharded.shard_streams(
        stream_state_from_numpy(gen, rst, dims, dev), grid)
    run.stream_to_numpy = lambda rst: stream_state_to_numpy(gen, rst)
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
    if streams.stream_mode_name(cfg.rng_mode):
        run.packed_stream_hot_start = lambda: sharded.shard_state(
            packed_stream_hot_start(cfg, dev), grid)
    return run


# ---------------------------------------------------------------------------
# the chain axis of a beta scan
# ---------------------------------------------------------------------------


def check_supported_chains(cfg: SimConfig) -> None:
    """check_supported for a scan on the packed engine, and a scan on an
    X/Y mesh with extended observables refused with ValueError, in the
    reference's words (qcdgpu_tpu/models/ensemble.py:106-112)."""
    check_supported(cfg)
    if int(np.prod(cfg.mesh)) > 1 and has_extended(cfg):
        raise ValueError(
            "extended observables (fmunu/wilson/qtop) are not "
            "supported on the chain x lattice Pallas path; use "
            "engine='xla' for such scans"
        )


def split_links_chains(u):
    """Complex [C, 4, N, N, X, Y, Z, T] -> the chain-stacked 8-tuple of
    [C, 2, N, 2, X, Y, Z*T/2] f32 (split_links of each chain)."""
    return tuple(torch.stack(arrs)
                 for arrs in zip(*(split_links(uc) for uc in u)))


def join_links_chains(us, dims):
    """The chain-stacked 8-tuple -> complex64 [C, 4, N, N, X, Y, Z, T]."""
    return torch.stack([join_links(tuple(a[c] for a in us), dims)
                        for c in range(us[0].shape[0])])


def packed_cold_start_chains(cfg: SimConfig, n_chains, device="cuda",
                             shard=None):
    """Unit links on every chain, chain-stacked (8 separate tensors); with
    ``shard`` its padded arrays."""
    return tuple(a.expand((n_chains,) + tuple(a.shape)).contiguous()
                 for a in packed_cold_start(cfg, device, shard))


def packed_hot_start_chains(cfg: SimConfig, base_keys, device="cuda",
                            shard=None):
    """Chain c's hot start is packed_hot_start under its base key
    base_keys[c] (the reference's vmap(hot_start)(keys),
    qcdgpu_tpu/models/ensemble.py:380-383), chain-stacked; with ``shard``
    its padded arrays, built from global coordinates."""
    per = [packed_hot_start(cfg, tuple(int(k) for k in key), device, shard)
           for key in base_keys]
    return tuple(torch.stack(arrs) for arrs in zip(*per))


def make_chain_sweep(cfg: SimConfig, grid):
    """sweep(shards, betas, base_keys, sweep_idx) -> shards (in place), or
    with tracking (shards, rate), rate f32 [C] on the first shard's device:
    each chain's tracked count, summed over the shards, over
    ``tracked_stat_denom``, as its single-chain sweep forms it.  shards:
    one chain-stacked 8-tuple per shard of ``grid`` (a ShardGrid; padded
    on a split axis); betas f32 [C], base_keys int32 [C, 2] (u32 bits),
    on the shards' device, where they stay.  Every stage of
    ``stage_schedule`` is one K1ac launch per shard over all C chains (K1c
    on a grid of one shard without halo: 8 (1 + n_or) launches per sweep,
    whatever C is), then the halo refresh of the array it wrote (one copy
    per slab for every chain); each reunitarization one K2c launch per
    array and shard, on the padded arrays whole."""
    dims = tuple(cfg.dims)
    tracking = tracks(cfg)
    denom = tracked_stat_denom(cfg, dims)
    schedule = stage_schedule(cfg)
    devices = list(dict.fromkeys(grid.devices))
    last = {"shards": None, "plan": None}

    def sweep(shards, betas, base_keys, sweep_idx):
        if last["shards"] is not shards:
            last.update(shards=shards,
                        plan=sharded.halo_copies(shards, grid))
        c = shards[0][0].shape[0]
        counts = ({d: torch.zeros(c, dtype=torch.int64, device=d)
                   for d in devices} if tracking else None)
        for kind, parity, mu, stage_id, counted in schedule:
            for g, d, us in zip(grid.shards, grid.devices, shards):
                cupdate.stage_update_chains(
                    us, mu, parity, betas, base_keys, sweep_idx, stage_id,
                    dims, cfg.kp_trials, kind=kind, n_hit=cfg.n_hit,
                    metro_delta=cfg.metro_delta,
                    count=counts[d] if counted else None,
                    rng_mode=cfg.rng_mode, shard=g)
            sharded.refresh_halos(shards, grid, (2 * mu + parity,),
                                  last["plan"])
        if reunit_due(cfg, sweep_idx):
            for g, us in zip(grid.shards, shards):
                for a in us:
                    reunitarize_chains(a, g.padded)
        if tracking:
            total = counts[devices[0]]
            for d in devices[1:]:
                total = total + counts[d].to(devices[0])
            return shards, total.to(torch.float32) / denom
        return shards

    return sweep


def measure_chains(shards, geoms, cfg=None):
    """Observable vectors [C, len(measure_obs_names(cfg))] of every chain
    of a block whose lattice the shards cover (``geoms``: their core.Shard
    geometries): K3c/K4c on a shard without halo, K5ac/K5bc on a padded
    one, each chain's f64 sums added in shard order on the first shard's
    device (as measure_shards adds a single chain's), then
    obs_base_from_sums elementwise over the chains; row c is measure_shards
    of chain c, bit for bit.  cfg's extended columns are measured on each
    chain's own joined field, unsharded only (check_supported_chains), so
    row c is measure_all_split of chain c."""
    dev = shards[0][0].device
    dims = tuple(geoms[0].dims)
    sums = poly = None
    for g, us in zip(geoms, shards):
        s = cmeasure.plane_sums_chains(us, dims, g).to(dev)
        p = cmeasure.polyakov_sums_chains(us, dims, g).to(dev)
        sums = s if sums is None else sums + s
        poly = p if poly is None else poly + p
    us = shards[0]
    return with_extended(
        obs_base_from_sums(sums, poly, us[0].shape[2], dims),
        lambda: (join_links(tuple(a[c] for a in us), dims)
                 for c in range(us[0].shape[0])), cfg)
