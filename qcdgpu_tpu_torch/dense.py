"""The dense engine: the whole-lattice, masked checkerboard Monte Carlo.

Port of the reference's XLA engine (qcdgpu_tpu/sim.py:55-284 and the XLA
branch of make_chunk_runner, :326-373) as PyTorch ops on one device:

    cold_start / hot_start / stream_hot_start   start states
    make_sweep_fn(cfg, with_acc)                 the sweep (threefry, stream)
    make_chunk_runner(cfg, device)               the runner Simulation drives

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

There is no hand-written kernel on this path: the reference's dense engine
is XLA ops, and its counterpart here is PyTorch ops, on the card unless
the caller passes device="cpu".  The stages write the links in place,
op by op.  A mesh is refused (check_mesh: M11b).

A beta scan runs C chains as one batched sweep (the reference's vmap,
models/ensemble.py:132-144): the field is [4, N, N, C, X, Y, Z, T], the
chain axis before the lattice axes, with a coupling and a key per chain
(``make_sweep_fn`` with ``beta`` a sequence and ``base_key`` a list) and
the stream words [..., C, X, Y, Z, T]; every operation is elementwise over
the chains, so chain c's links are its single-chain sweep's bit for bit.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .config import SimConfig, stream_mode_name
from .ops import prng_streams as streams
from .ops import rng, sun
from .ops.cuda import engine
from .ops.lattice import parity_mask, site_index
from .ops.measure import make_measure_fn
from .ops.samplers import (stage_uniform_count, two_beta_over_n,
                           update_links)
from .ops.staples import staple_sum
from .parallel.mesh import shard_grid

NDIM = 4
STAGE_INIT = engine.STAGE_INIT
CHAIN_AXIS = -5  # a scan's chain axis in a per-direction field or a word


def cdtype(cfg: SimConfig) -> torch.dtype:
    return torch.complex128 if cfg.dtype == "complex128" else torch.complex64


def check_mesh(cfg: SimConfig, what="the dense engine") -> None:
    """Refuse a mesh: the dense engine runs on one device (M11b)."""
    if int(np.prod(cfg.mesh)) != 1:
        zt = cfg.mesh[2] != 1 or cfg.mesh[3] != 1
        raise NotImplementedError(
            "not ported yet (see ROADMAP.md): "
            + (f"mesh={tuple(cfg.mesh)} splits Z/T, which only the dense "
               "engine runs" if zt else
               f"{what} (engine={cfg.engine!r}, dtype={cfg.dtype!r}, "
               f"rng_mode={cfg.rng_mode!r}) on mesh={tuple(cfg.mesh)}")
            + " (M11b: the dense engine on a mesh)")


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


def make_sweep_fn(cfg: SimConfig, with_acc: bool = False):
    """sweep(u, base_key, sweep_idx, beta=None) -> u for threefry (and
    rng_mode "hw", which the dense engine draws as threefry), or, with
    rng_mode="prngcl:<gen>", stream_sweep((u, rst), base_key, sweep_idx,
    beta=None) -> (u, rst'); with with_acc each returns (state, rate), the
    sweep's tracked statistic: the mean Metropolis acceptance
    (track_acceptance) or KP trial exhaustion (track_kp_exhaust) of the
    tracked stages (qcdgpu_tpu/sim.py:122-232).

    u is updated IN PLACE (and returned).  beta=None takes cfg.beta; a
    beta scan passes one coupling per chain and base_key as a list of the
    chains' keys, with u [4, N, N, C, X, Y, Z, T]."""
    dims = tuple(cfg.dims)
    kinds = [cfg.algorithm] + ["overrelax"] * cfg.n_or
    gen = stream_mode_name(cfg.rng_mode)
    track_kind = "heatbath" if cfg.track_kp_exhaust else "metropolis"
    geom = {}
    couplings = {}

    def lattice(device):
        if device not in geom:
            geom[device] = (site_index(dims, device),
                            [parity_mask(dims, p, device) for p in (0, 1)])
        return geom[device]

    def two_beta(b, device):
        # 2 beta / N on the device, made once for a coupling (or the
        # couplings of a scan: a [C, 1, 1, 1, 1] tensor, so the key holds
        # the rank)
        bb = np.asarray(b, np.float64)
        k = (device, bb.ndim, tuple(bb.ravel()))
        if k not in couplings:
            couplings[k] = two_beta_over_n(b, cfg.group, device)
        return couplings[k]

    def stage(u, randomness, parity, mu, kind, beta):
        # randomness: the stage key, or the pre-drawn uniforms of a stream
        sidx, masks = lattice(u.device)
        track = with_acc and kind == track_kind
        b = cfg.beta if beta is None else beta
        kw = dict(k_trials=cfg.kp_trials, n_hit=cfg.n_hit,
                  metro_delta=cfg.metro_delta, return_acc=track,
                  two_beta=two_beta(b, u.device))
        a = staple_sum(u, mu)
        if gen is None:
            new = update_links(u[mu], a, kind, b, randomness, sidx, **kw)
        else:
            new = update_links(u[mu], a, kind, b, None, None,
                               uniforms=randomness, **kw)
        acc = None
        if track:
            new, acc = new
        u[mu] = torch.where(masks[parity], new, u[mu])
        return acc

    def finish(u, sweep_idx):
        if (cfg.reunit_every > 0
                and sweep_idx % cfg.reunit_every == cfg.reunit_every - 1):
            for m in range(NDIM):
                u[m] = sun.reunitarize(u[m])

    def result(state, acc_sum, acc_n):
        # with_acc: cfg tracks its algorithm's own kind, so acc_n > 0
        return (state, acc_sum / acc_n) if with_acc else state

    def sweep(u, base_key, sweep_idx, beta=None):
        stage_id = 0
        acc_sum, acc_n = 0.0, 0
        for kind in kinds:
            for parity in (0, 1):
                for mu in range(NDIM):
                    key = _stage_keys(base_key, sweep_idx, stage_id, u.device)
                    acc = stage(u, key, parity, mu, kind, beta)
                    if acc is not None:
                        acc_sum, acc_n = acc_sum + acc, acc_n + 1
                    stage_id += 1
        finish(u, sweep_idx)
        return result(u, acc_sum, acc_n)

    if gen is None:
        return sweep
    n_upd = stage_uniform_count(cfg.group, cfg.algorithm, cfg.kp_trials,
                                cfg.n_hit)

    def stream_sweep(state, base_key, sweep_idx, beta=None):
        u, rst = state
        acc_sum, acc_n = 0.0, 0
        for kind in kinds:
            for parity in (0, 1):
                for mu in range(NDIM):
                    uu = None
                    if kind != "overrelax":
                        uu, rst = streams.stream_draw(gen, rst, n_upd)
                        uu = streams.open01(uu)
                    acc = stage(u, uu, parity, mu, kind, beta)
                    if acc is not None:
                        acc_sum, acc_n = acc_sum + acc, acc_n + 1
        finish(u, sweep_idx)
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


def make_chunk_runner(cfg: SimConfig, device="cuda"):
    """The dense engine's runner, with the surface Simulation drives on the
    packed one (ops/cuda/engine.py make_chunk_runner): run(u, key, sweep0,
    n, me) and run.packed on state (u, rst), run.pack / run.unpack,
    run.packed_cold_start, run.packed_hot_start(key),
    run.packed_stream_hot_start (stream mode), run.make_stream_state0,
    run.measure_packed, run.adopt (a given start state), run.adopt_streams
    / run.stream_to_numpy (the stream state at the host boundary),
    run.scatter / run.gather (identities: one device, no shards), run.grid
    and run.engine = "xla".  rst is the dense stream state, {} with
    threefry.  A mesh is refused (check_mesh: M11b)."""
    from .runner import build_chunk_runner

    check_mesh(cfg)
    dev = engine.resolve_device(device)
    if cfg.rng_mode == "hw":
        # the reference's words (qcdgpu_tpu/sim.py:326-338)
        warnings.warn(
            "rng_mode='hw' requested but the run resolved to the XLA "
            "engine, which always draws threefry streams; results are "
            "produced with rng_mode='threefry'",
            stacklevel=2,
        )
    gen = stream_mode_name(cfg.rng_mode)
    tracking = engine.tracks(cfg)
    sweep = make_sweep_fn(cfg, with_acc=tracking)
    meas = make_measure_fn(cfg)
    dims = tuple(cfg.dims)

    def make_stream_state0():
        if gen is None:
            return {}
        return streams.make_stream_state(gen, cfg.seed, dims, dev)

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
        pack=lambda u: (field_from_input(u, cfg, dev), make_stream_state0()),
        unpack=lambda st: st[0].clone(), with_acc=tracking, device=dev)
    run.engine = "xla"
    run.grid = shard_grid(cfg, dev)
    run.scatter = lambda u: u
    run.gather = lambda st: st
    run.adopt = lambda arrays: field_from_input(arrays, cfg, dev)
    run.packed_cold_start = lambda: cold_start(cfg, dev)
    run.packed_hot_start = lambda key: hot_start(cfg, key, dev)
    run.measure_packed = meas
    run.make_stream_state0 = make_stream_state0
    run.stream_state_keys = dense_stream_keys(gen) if gen else frozenset()
    run.adopt_streams = lambda rst: stream_from_numpy(gen, rst, dims, dev)
    run.stream_to_numpy = lambda rst: stream_to_numpy(gen, rst)
    if gen is not None:
        run.packed_stream_hot_start = lambda: stream_hot_start(
            cfg, make_stream_state0())
    return run
