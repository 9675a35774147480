"""The beta-scan ensemble: C independent Markov chains, one per coupling,
on one lattice — port of qcdgpu_tpu/models/ensemble.py (its Pallas chain
tiers, ensemble.py:96-131, and its chain meshes, :209-270).

    scan = BetaScan(baseline_config(3), betas)   # on the card
    scan.warmup().thermalize(n)
    obs = scan.run(n, measure_every)   # numpy [C, n // me, len(obs_names)]
    scan.save(path); scan = BetaScan.load(path)  # exact resume

The state is chain-stacked (ops/cuda/engine.py): each of the 8 packed
arrays is ``[C, 2, N, 2, X, Y, Z*T/2]``, with the couplings (f32 [C]) and
base keys (u32 [C, 2]) beside it on the device.  A sweep launches each
stage once for all chains (K1c), each chain under its own coupling and key;
reunitarization (K2c) and measurement (K3c/K4c) batch the chains the same
way.  Chain c draws under ``rng.make_base_key(cfg.seed + 1000 c)`` and is,
bit for bit, the single-chain ``Simulation`` of seed ``cfg.seed + 1000 c``
and beta ``betas[c]``.

The chain x lattice layout: with ``cfg.mesh = (mx, my, 1, 1)`` every
chain's lattice is cut into the X/Y shards of that mesh, each shard's
arrays chain-stacked and halo-padded, and a stage is one K1ac launch per
shard for all chains, then the halo refresh (K5ac/K5bc measure); chain c
is then its sharded ``Simulation`` on the same mesh, bit for bit, and the
unsharded scan's chain c in its links.  ``chain_mesh`` cuts the chains into
that many equal blocks (parallel/mesh.py ChainGrid), each with its own
shards, all on ``device`` unless ``devices`` spreads the blocks (block b on
``devices[b % len(devices)]``); chain_mesh 0 (auto) takes the largest
divisor of C that fits the cards of ``devices`` // prod(cfg.mesh), and 1
without ``devices`` or on the CPU.  Blocks change nothing in any chain.
They exist for parity with the reference's layout and make no scan
faster: the blocks run one after the other from one host thread, and the
scan is host-bound, so each block adds its launches to a sweep (PERF.md
§5).

Supported: threefry and rng_mode "hw" (Philox), SU(2) and SU(3), every
update algorithm, the tracked statistics (one column per chain), the
extended observables without a mesh (each chain's on its own joined
field), cold and hot starts, X/Y meshes and chain blocks.  A scan on an
X/Y mesh with extended observables raises ValueError, as the reference's
does.

The dense tier (the reference's vmap tier, ensemble.py:132-144, 181-190,
285-310, and its XLA tier on the combined mesh and in chain blocks,
:209-216 and after :242): a scan whose configuration resolves to the
dense engine (complex128, engine="xla", a Z/T mesh) or draws from PRNGCL
streams runs on it (dense.py): the C chains are one batched dense sweep
on the field [4, N, N, C, X, Y, Z, T], each chain with its coupling, its
key and, in stream mode, its streams seeded at ``cfg.seed + 1000 c`` (the
words [..., C, X, Y, Z, T]; ranlux's nb and ranmar's c shared, as they
advance with the draw count alone).  With ``cfg.mesh`` the lattice axes
of that field are cut into the shards of a DenseGrid (any of the four
axes; dense_sharded.py), and ``chain_mesh`` cuts the chains into blocks,
each its own batched sweep on its own grid, block b on ``devices[b %
len(devices)]``.  Chain c's links are, bit for bit, its own dense
``Simulation`` (engine "xla", seed ``cfg.seed + 1000 c``, beta
``betas[c]``) on the same mesh, and the unsharded one's; each chain is
measured on its own shards, so its series is that Simulation's too.  The
extended observables run on every mesh there (each chain's field
gathered first).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import dense, dense_sharded
from ..config import SimConfig, resolve_engine, stream_mode_name
from ..ops import prng_streams as streams
from ..ops import rng
from ..ops.cuda import engine, sharded
from ..ops.measure import obs_names
from ..parallel.mesh import ChainGrid, block_cards, resolve_chain_mesh
from ..runner import build_chunk_runner
from ..utils import profile


def make_ensemble_runner(cfg: SimConfig, n_chains: int, device="cuda",
                         chain_mesh: int = 1, devices=None):
    """Runner over C = n_chains chains with per-chain beta and key, on the
    shared chunk runner: run.packed(state, None, sweep0, n, me).  The
    chains are cut into ``chain_mesh`` blocks (run.grid, a ChainGrid; C %
    chain_mesh != 0 raises ValueError), block b on ``devices[b %
    len(devices)]`` (default: every block on ``device``).  State is one
    (shards, betas, keys) per block: the block's chain-stacked 8-tuple per
    shard of cfg.mesh (one shard without halo when unsharded), f32 [Cb] and
    int32 [Cb, 2] (u32 bits) on the block's device (run.state builds it);
    the runner's key argument is unused (each chain carries its own).  Rows
    are the C chains' rows flattened chain-major, [C * n_obs], on
    ``device``, with one tracked column per chain.  run.packed_cold_start()
    and run.packed_hot_start(keys) build the blocks' links; run.scatter /
    run.gather convert between them and the global chain-stacked
    8-tuple."""
    engine.check_supported_chains(cfg)
    dev = engine.resolve_device(device)
    cgrid = ChainGrid(cfg, n_chains, chain_mesh, [dev] if devices is None
                      else [engine.resolve_device(d) for d in devices])
    with_acc = engine.tracks(cfg)
    n_obs = len(obs_names(cfg))
    sweeps = [engine.make_chain_sweep(cfg, g) for g in cgrid.grids]

    def sweep(st, _key, sweep_idx):
        out, rates = [], []
        for chain_sweep, (shards, betas, keys) in zip(sweeps, st):
            r = chain_sweep(shards, betas, keys, sweep_idx)
            if with_acc:
                r, rate = r
                rates.append(rate.to(dev))
            out.append((r, betas, keys))
        if with_acc:
            return tuple(out), torch.cat(rates)
        return tuple(out)

    def measure_state(st):
        return torch.cat([engine.measure_chains(b[0], g.shards, cfg).to(dev)
                          for b, g in zip(st, cgrid.grids)]).reshape(-1)

    def per_shard(make):
        """make(chains, shard, device) for every shard of every block."""
        return tuple(tuple(make(chains, g, d)
                           for g, d in zip(grid.shards, grid.devices))
                     for chains, grid in zip(cgrid.blocks, cgrid.grids))

    def gather(blocks):
        parts = [sharded.gather_links(b, g)
                 for b, g in zip(blocks, cgrid.grids)]
        if len(parts) == 1:
            return parts[0]
        return tuple(torch.cat([p[k].to(dev) for p in parts])
                     for k in range(len(parts[0])))

    run = build_chunk_runner(cfg, sweep, measure_state, with_acc=with_acc,
                             device=dev, n_obs=n_chains * n_obs)
    run.grid = cgrid
    run.packed_cold_start = lambda: per_shard(
        lambda chains, g, d: engine.packed_cold_start_chains(
            cfg, len(chains), d, g))
    run.packed_hot_start = lambda keys: per_shard(
        lambda chains, g, d: engine.packed_hot_start_chains(
            cfg, [keys[c] for c in chains], d, g))
    run.scatter = lambda us: tuple(
        sharded.shard_links(tuple(a[chains.start:chains.stop] for a in us),
                            g)
        for chains, g in zip(cgrid.blocks, cgrid.grids))
    run.gather = gather
    run.state = lambda blocks, betas, keys: tuple(
        (b, betas_tensor(betas[chains.start:chains.stop], g.devices[0]),
         keys_tensor(keys[chains.start:chains.stop], g.devices[0]))
        for b, chains, g in zip(blocks, cgrid.blocks, cgrid.grids))
    return run


def make_dense_ensemble_runner(cfg: SimConfig, betas, keys, device="cuda",
                               chain_mesh: int = 1, devices=None):
    """Runner of the dense tier over C = len(betas) chains, on the shared
    chunk runner: run.packed(state, None, sweep0, n, me); chain c sweeps
    under betas[c] and base key keys[c] (u32 pairs).  The chains are cut
    into ``chain_mesh`` blocks (run.grid, a ChainGrid of DenseGrids), block
    b on ``devices[b % len(devices)]`` (default: every block on
    ``device``).  State is one (shards, rst) per block: the block's chain
    field [4, N, N, Cb, X, Y, Z, T] in cfg.dtype cut into the shards of
    cfg.mesh (one shard without halo when unsharded), and its chains'
    sharded dense stream state ({} with threefry).  Rows are the C chains'
    rows flattened chain-major, [C * n_obs] on ``device``, each chain
    measured on its own shards as its Simulation measures them, with one
    tracked column per chain.  run.packed_cold_start,
    run.packed_hot_start(keys), run.packed_stream_hot_start() (stream
    mode) and run.adopt(u, rst) (the global chain field, u [C, 4, N, N, X,
    Y, Z, T], and chain-stacked stream state) build the state;
    run.chains / run.streams gather the fields [C, 4, N, N, X, Y, Z, T]
    and the chain-stacked stream state back."""
    dev = engine.resolve_device(device)
    n_chains = len(betas)
    cgrid = ChainGrid(cfg, n_chains, chain_mesh, [dev] if devices is None
                      else [engine.resolve_device(d) for d in devices],
                      dense=True)
    gen = stream_mode_name(cfg.rng_mode)
    tracking = engine.tracks(cfg)
    beta = np.asarray(betas, np.float32).astype(np.float64)
    key_list = [tuple(int(k) for k in key) for key in keys]
    cdt = dense.cdtype(cfg)
    blocks = [(chains, g, dense.make_sweep_fn(cfg, tracking, g),
               dense_sharded.make_measure(cfg, g))
              for chains, g in zip(cgrid.blocks, cgrid.grids)]

    def step(st, _key, sweep_idx):
        out, rates = [], []
        for (chains, _, sweep, _), (shards, rst) in zip(blocks, st):
            ks = key_list[chains.start:chains.stop]
            bs = beta[chains.start:chains.stop]
            if gen is None:
                r = sweep(shards, ks, sweep_idx, beta=bs)
                r = ((r[0], rst), r[1]) if tracking else (r, rst)
            else:
                r = sweep((shards, rst), ks, sweep_idx, beta=bs)
            if tracking:
                r, rate = r
                rates.append(rate.reshape(-1).to(dev))
            out.append(r)
        if tracking:
            return tuple(out), torch.cat(rates)
        return tuple(out)

    def measure_state(st):
        return torch.cat([
            meas(tuple(u.select(3, c).contiguous() for u in shards)).to(dev)
            for (chains, _, _, meas), (shards, _) in zip(blocks, st)
            for c in range(len(chains))])

    def adopt(u, rst):
        """The global chain field [4, N, N, C, X, Y, Z, T] and the
        chain-stacked stream state -> the blocks' sharded state."""
        out = []
        for chains, g, _, _ in blocks:
            part = {k: v.narrow(dense.CHAIN_AXIS, chains.start, len(chains))
                    if isinstance(v, torch.Tensor) else v
                    for k, v in rst.items()}
            out.append((dense_sharded.scatter(
                u.narrow(3, chains.start, len(chains)), g),
                dense_sharded.scatter_streams(part, g)))
        return tuple(out)

    def streams0():
        if gen is None:
            return {}
        return stack_streams([streams.make_stream_state(
            gen, cfg.seed + 1000 * c, cfg.dims, dev) for c in range(n_chains)])

    def hot_streams():
        us, states = [], []
        for c in range(n_chains):
            u, st = dense.stream_hot_start(cfg, streams.make_stream_state(
                gen, cfg.seed + 1000 * c, cfg.dims, dev))
            us.append(u)
            states.append(st)
        return adopt(torch.stack(us, dim=3), stack_streams(states))

    def chains_of(st):
        parts = [dense_sharded.gather(shards, g).to(dev)
                 for (_, g, _, _), (shards, _) in zip(blocks, st)]
        return torch.cat(parts, dim=3).movedim(3, 0).contiguous()

    def streams_of(st):
        parts = [dense_sharded.gather_streams(rst, g)
                 for (_, g, _, _), (_, rst) in zip(blocks, st)]
        return {k: torch.cat([p[k].to(dev) for p in parts],
                             dim=dense.CHAIN_AXIS)
                if isinstance(v, torch.Tensor) else v
                for k, v in parts[0].items()}

    run = build_chunk_runner(cfg, step, measure_state, with_acc=tracking,
                             device=dev,
                             n_obs=n_chains * len(obs_names(cfg)))
    run.engine = "xla"
    run.grid = cgrid
    run.adopt = lambda u, rst: adopt(
        torch.as_tensor(u).to(dev, cdt).movedim(0, 3).contiguous(),
        {} if gen is None else rst)
    run.packed_cold_start = lambda: adopt(
        dense.cold_start(cfg, dev).unsqueeze(3).expand(
            (-1, -1, -1, n_chains) + tuple(cfg.dims)).contiguous(),
        streams0())
    run.packed_hot_start = lambda ks: adopt(torch.stack(
        [dense.hot_start(cfg, tuple(int(k) for k in key), dev)
         for key in ks], dim=3), streams0())
    if gen is not None:
        run.packed_stream_hot_start = hot_streams
    run.chains = chains_of
    run.streams = streams_of
    return run


def stack_streams(states):
    """Per-chain dense stream states -> one state with the chain axis at
    dense.CHAIN_AXIS of every word array; the scalars (nb, c) are equal
    across chains and kept once."""
    out = {}
    for k, v in states[0].items():
        if isinstance(v, torch.Tensor):
            out[k] = torch.stack([st[k] for st in states], dim=dense.CHAIN_AXIS)
        else:
            if any(st[k] != v for st in states):
                raise ValueError(f"stream scalar {k} differs across chains")
            out[k] = v
    return out


def betas_tensor(betas, device):
    """Couplings as the kernels take them: f32 [C] on ``device``."""
    return torch.as_tensor(np.asarray(betas, np.float32)).to(device)


def keys_tensor(keys, device):
    """u32 base keys [C, 2] as the kernels take them: their int32 bits."""
    bits = np.ascontiguousarray(np.asarray(keys, np.uint32)).view(np.int32)
    return torch.from_numpy(bits.copy()).to(device)


def _clone(x):
    """A copy of nested tuples of tensors."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    return tuple(_clone(v) for v in x)


class BetaScan:
    """Finite-temperature / coupling scan: one chain per beta on a shared
    lattice; the Polyakov-loop series across the grid locates the
    deconfinement transition (BASELINE config 3: 24^3 x 6).

    ``us`` is the chain-stacked packed state (gathered from the chain
    blocks and shards; with one block and no mesh the live tensors the
    kernels update in place) and ``u`` the canonical complex fields [C, 4,
    N, N, X, Y, Z, T], as ``Simulation.us`` / ``Simulation.u``; ``betas``
    (f32 [C]), ``keys`` (u32 [C, 2], chain c's base key) and ``sweep_idx``
    are the rest of the state.  ``device`` is 'cuda' (the default) or
    'cpu'; 'cuda' without a card raises."""

    def __init__(self, cfg: SimConfig, betas, chain_mesh: int = 1, *,
                 device="cuda", devices=None, _init=None):
        """chain_mesh: the number of chain blocks, which must divide C; 0
        (auto) resolves it from the cards that ``devices`` names
        (block_cards, resolve_chain_mesh): 1 without ``devices``.  A
        run-time choice, as in the reference: it changes no chain and is
        not saved.  Blocks are there for parity with the reference and are
        slower than one block, since one host thread launches them one
        after the other.  devices: where the blocks go, block b on
        devices[b % len(devices)] (default: all on ``device``).  _init:
        (u, keys, sweep_idx, stream state or None) of a checkpoint
        (load())."""
        self.cfg = cfg
        # the reference scans streams on its dense engine
        # (qcdgpu_tpu/models/ensemble.py:132-144)
        dense_tier = (resolve_engine(cfg) == "xla"
                      or stream_mode_name(cfg.rng_mode) is not None)
        self.engine = "xla" if dense_tier else "pallas"
        if not dense_tier:
            engine.check_supported_chains(cfg)
        self.device = engine.resolve_device(device)
        self.betas = np.asarray(betas, np.float32).reshape(-1)
        c = len(self.betas)
        if c < 1:
            raise ValueError("a scan needs at least one beta")
        if devices is not None:
            devices = [engine.resolve_device(d) for d in devices]
        self.chain_mesh = resolve_chain_mesh(chain_mesh, cfg, c,
                                             block_cards(devices))
        self._n_obs = len(obs_names(cfg))
        self.sweep_idx = 0
        if dense_tier:
            self._init_dense(_init, devices)
            return
        self._run = make_ensemble_runner(cfg, c, self.device,
                                         self.chain_mesh, devices)
        if _init is not None:
            u, keys, self.sweep_idx = _init[:3]
            self.keys = np.asarray(keys, np.uint32).reshape(c, 2)
            blocks = self._run.scatter(engine.split_links_chains(
                torch.as_tensor(np.asarray(u, np.complex64)).to(self.device)))
        else:
            self.keys = np.array([rng.make_base_key(cfg.seed + 1000 * i)
                                  for i in range(c)], np.uint32)
            if cfg.start == "hot":
                blocks = self._run.packed_hot_start(self.keys.tolist())
            elif cfg.start == "continue":
                raise ValueError(
                    "start='continue' resumes a checkpoint: use "
                    "BetaScan.load(path) (CLI: `scan --resume-state`)")
            else:
                blocks = self._run.packed_cold_start()
        self._st = self._run.state(blocks, self.betas, self.keys)

    def _init_dense(self, init, devices):
        """The dense tier's state, one (shards, rst) per chain block
        (make_dense_ensemble_runner)."""
        cfg, c = self.cfg, len(self.betas)
        if init is not None:
            u, keys, self.sweep_idx, rst = init
            self.keys = np.asarray(keys, np.uint32).reshape(c, 2)
        else:
            self.keys = np.array([rng.make_base_key(cfg.seed + 1000 * i)
                                  for i in range(c)], np.uint32)
        self._run = make_dense_ensemble_runner(
            cfg, self.betas, self.keys, self.device, self.chain_mesh,
            devices)
        gen = stream_mode_name(cfg.rng_mode)
        if init is not None:
            if gen is not None and rst is None:
                raise ValueError(
                    "checkpoint has no PRNGCL stream state but the config "
                    f"runs rng_mode={cfg.rng_mode!r}; cannot resume exactly")
            if gen is not None:
                rst = {k: np.moveaxis(v, 0, dense.CHAIN_AXIS)
                       if np.ndim(v) >= 5 else v for k, v in rst.items()}
                rst = dense.stream_from_numpy(gen, rst, cfg.dims,
                                              self.device)
            self._st = self._run.adopt(u, rst)
        elif cfg.start == "hot" and gen is not None:
            self._st = self._run.packed_stream_hot_start()
        elif cfg.start == "hot":
            self._st = self._run.packed_hot_start(self.keys.tolist())
        elif cfg.start == "continue":
            raise ValueError(
                "start='continue' resumes a checkpoint: use "
                "BetaScan.load(path) (CLI: `scan --resume-state`)")
        else:
            self._st = self._run.packed_cold_start()

    # -- state ------------------------------------------------------------
    @property
    def us(self):
        """The chain-stacked packed 8-tuple of all chains: the live tensors
        with one chain block and no mesh, else gathered (new).  On the
        dense tier the chains' fields, as ``u``."""
        if self.engine == "xla":
            return self.u
        return self._run.gather(tuple(b[0] for b in self._st))

    @property
    def u(self):
        """Canonical complex fields [C, 4, N, N, X, Y, Z, T] (new):
        complex64, or cfg.dtype on the dense tier."""
        if self.engine == "xla":
            return self._run.chains(self._st)
        return engine.join_links_chains(self.us, tuple(self.cfg.dims))

    @property
    def stream_state(self):
        """The dense tier's stream state as numpy in the reference's
        ``betascan`` layout (word arrays chain-leading, [C, ...]; nb, c
        once), or None outside stream mode."""
        gen = stream_mode_name(self.cfg.rng_mode)
        if gen is None:
            return None
        out = dense.stream_to_numpy(gen, self._run.streams(self._st))
        return {k: np.moveaxis(v, dense.CHAIN_AXIS, 0) if np.ndim(v) >= 5
                else v for k, v in out.items()}

    @property
    def obs_names(self):
        return obs_names(self.cfg)

    def sync(self) -> float:
        """Wait for the queued work of every card the scan uses (no-op on
        the CPU); returns the seconds spent waiting."""
        t0 = time.perf_counter()
        for d in dict.fromkeys(d for g in self._run.grid.grids
                               for d in g.devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return time.perf_counter() - t0

    # -- simulation -------------------------------------------------------
    def warmup(self, measure_every=None):
        """Build the kernels and run one sweep, then one measured block, on
        a CLONE of the links: the kernels update in place, so the live
        chains stay exactly as they were (Simulation.warmup)."""
        me = self.cfg.meas_every if measure_every is None else measure_every
        st = (tuple(engine.clone_state(b) for b in self._st)
              if self.engine == "xla" else _clone(self._st))
        scratch, _ = self._run.packed(st, None, self.sweep_idx, 1, 0)
        if me:
            self._run.packed(scratch, None, self.sweep_idx, me, me)
        self.sync()
        return self

    def thermalize(self, n=None):
        if profile.ON:
            profile.begin("sim.thermalize")
        n = self.cfg.sweeps_therm if n is None else n
        if n > 0:
            self._st, _ = self._run.packed(self._st, None, self.sweep_idx,
                                           n, 0)
            self.sweep_idx += n
        if profile.ON:
            profile.end("sim.thermalize")
        return self

    def run(self, n=None, measure_every=None):
        """Production sweeps; returns numpy [C, n // me, len(obs_names)]
        (this waits for the device)."""
        if profile.ON:
            profile.begin("sim.run")
        n = self.cfg.sweeps if n is None else n
        me = self.cfg.meas_every if measure_every is None else measure_every
        self._st, obs = self._run.packed(self._st, None, self.sweep_idx, n,
                                         me)
        self.sweep_idx += n
        if profile.ON:
            profile.begin("sim.rows_to_host")
        obs = obs.cpu().numpy()  # [n_meas, C * n_obs]
        if profile.ON:
            profile.end("sim.rows_to_host")
        c = len(self.betas)
        out = obs.reshape(obs.shape[0], c, self._n_obs).transpose(1, 0, 2)
        if profile.ON:
            profile.end("sim.run")
        return out

    # -- checkpoint -------------------------------------------------------
    def save(self, path: str):
        """The reference's ``betascan`` .npz (utils/checkpoint.py), which
        qcdgpu_tpu's BetaScan.load reads too.  With a counter-based random
        source (keys, sweep_idx) is the whole random state; a stream scan
        adds its chains' stream state."""
        from ..utils.checkpoint import save_betascan

        if profile.ON:
            profile.begin("sim.save")
        save_betascan(path, self.cfg, self.betas, self.keys, self.u,
                      self.sweep_idx, rng_stream=self.stream_state)
        if profile.ON:
            profile.end("sim.save")

    @classmethod
    def load(cls, path: str, chain_mesh: int = 1, *, device="cuda",
             devices=None, mesh=None):
        """Resume a ``betascan`` checkpoint written by either package (on
        any mesh and chain blocks); every chain continues bit for bit.
        ``mesh`` puts the resumed scan on another X/Y mesh than the saved
        configuration's (the file holds the global fields)."""
        from ..utils.checkpoint import load_betascan, load_betascan_streams

        cfg, betas, keys, u, sweep_idx = load_betascan(path)
        if mesh is not None:
            cfg = cfg.replace(mesh=tuple(mesh))
        return cls(cfg, betas, chain_mesh, device=device, devices=devices,
                   _init=(u, keys, sweep_idx, load_betascan_streams(path)))
