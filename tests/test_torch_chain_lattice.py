"""The chain x lattice beta scan on the CPU (plain twins of K1ac, K5ac,
K5bc and K2c on padded arrays): a scan on an X/Y mesh, its chains in
blocks.  The chain twins against the single-chain shard twins, the
chain-stacked halo refresh and shard round trip, each chain against its
sharded Simulation and the unsharded scan, chain blocks against one
block, the reference's chain x lattice scan, the auto chain mesh, the
checkpoint across meshes and packages, and the command line."""

import json
import os

import numpy as np
import pytest
import torch

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.models.ensemble import BetaScan as RefBetaScan
from qcdgpu_tpu_torch import SimConfig, Simulation, cli
from qcdgpu_tpu_torch.models import BetaScan
from qcdgpu_tpu_torch.models.ensemble import keys_tensor
from qcdgpu_tpu_torch.ops import rng
from qcdgpu_tpu_torch.ops.cuda import engine, sharded
from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure
from qcdgpu_tpu_torch.ops.cuda import reunit as creunit
from qcdgpu_tpu_torch.ops.cuda import update as cupdate
from qcdgpu_tpu_torch.parallel.mesh import (ShardGrid, block_cards,
                                           resolve_chain_mesh)
from qcdgpu_tpu_torch.utils.checkpoint import load_betascan

torch.set_num_threads(1)

SU2 = dict(group=2, dims=(4, 4, 2, 4), reunit_every=2)
SU3 = dict(group=3, dims=(8, 8, 4, 4), reunit_every=2)
BETAS = {2: (2.1, 2.3, 2.5, 2.7), 3: (5.7, 6.1)}


def _hot_shards(kw, mesh, n_chains, seed):
    """Chain-stacked hot starts of chains seed + 1000 c, cut into the
    padded shards of mesh: (grid, shards, keys)."""
    cfg = SimConfig(**kw)
    keys = [rng.make_base_key(seed + 1000 * c) for c in range(n_chains)]
    us = engine.packed_hot_start_chains(cfg, keys, "cpu")
    grid = ShardGrid(cfg.dims, mesh, ["cpu"])
    return grid, sharded.shard_links(us, grid), keys


@pytest.mark.parametrize("kw,mesh,kind,track,mode", [
    (SU2, (2, 2, 1, 1), "heatbath", True, "threefry"),
    (SU2, (2, 2, 1, 1), "overrelax", False, "threefry"),
    (SU2, (2, 1, 1, 1), "metropolis", True, "hw"),
    (SU2, (2, 1, 1, 1), "metropolis", False, "threefry"),
    (SU3, (2, 1, 1, 1), "heatbath", False, "hw"),
], ids=["su2-hb-kp-xy", "su2-or-xy", "su2-metro-acc-hw-x", "su2-metro-x",
        "su3-hb-hw-x"])
def test_chain_twins_are_the_shard_twins(kw, mesh, kind, track, mode):
    """K1ac's twin on a shard's chain-stacked padded arrays equals K1a's
    twin on each chain's own padded arrays (the whole padded arrays, halos
    untouched, counts per chain); K5ac / K5bc equal K5a / K5b per chain;
    K2c on padded arrays equals K2 per chain: bit for bit."""
    n, dims = kw["group"], kw["dims"]
    c = 3 if n == 2 else 2
    grid, shards, keys = _hot_shards(kw, mesh, c, 7)
    betas = torch.tensor(BETAS[n][:c], dtype=torch.float32)
    kt = keys_tensor(keys, "cpu")
    mu, parity, sweep, sid = 1, 1, 5, 6
    key = [rng.stage_key(k, sweep, sid) if kind != "overrelax" else (0, 0)
           for k in keys]
    for g, us in zip(grid.shards, shards):
        chains = tuple(a.clone() for a in us)
        count = torch.zeros(c, dtype=torch.int64) if track else None
        cupdate.stage_update_chains(chains, mu, parity, betas, kt, sweep,
                                    sid, dims, 1, kind=kind, count=count,
                                    rng_mode=mode, shard=g)
        for i in range(c):
            one = tuple(a[i].clone() for a in us)
            cnt = torch.zeros(1, dtype=torch.int64) if track else None
            cupdate.stage_update_ref(one, mu, parity, float(betas[i]), key[i],
                                     dims, 1, kind=kind, count=cnt,
                                     rng_mode=mode, shard=g)
            assert all(torch.equal(a[i], b) for a, b in zip(chains, one))
            if track:
                assert int(count[i]) == int(cnt)
        sums = cmeasure.plane_sums_chains(chains, dims, g)
        poly = cmeasure.polyakov_sums_chains(chains, dims, g)
        drift = chains[3] * 1.001
        single = drift.clone()
        creunit.reunitarize_chains(drift, g.padded)
        for i in range(c):
            view = tuple(a[i] for a in chains)
            assert torch.equal(sums[i], cmeasure.plane_sums_local(view, g))
            assert torch.equal(poly[i], cmeasure.polyakov_sums_local(view, g))
            creunit.reunitarize_dir_ref(single[i], g.padded)
        assert torch.equal(drift, single)


@pytest.mark.parametrize("mesh", [(2, 1, 1, 1), (2, 2, 1, 1)])
def test_chain_stacked_halos_and_round_trip(mesh):
    """shard_links / gather_links round-trip a chain-stacked state exactly
    and cut each chain as they cut it alone; the chain-stacked halo
    refresh (one copy per slab for every chain) equals each chain's
    own."""
    grid, shards, keys = _hot_shards(SU2, mesh, 3, 4)
    us = sharded.gather_links(shards, grid)
    assert us[0].shape[0] == 3
    back = sharded.shard_links(us, grid)
    for s, g in enumerate(grid.shards):
        alone = [sharded.shard_links(tuple(a[i] for a in us), grid)[s]
                 for i in range(3)]
        for k in range(8):
            assert torch.equal(back[s][k], shards[s][k])
            for i in range(3):
                assert torch.equal(shards[s][k][i], alone[i][k])
    # scramble every halo, then refresh: the halos come back, and each
    # chain's refresh alone gives the same bits
    per_chain = [tuple(tuple(a[i].clone() for a in sh) for sh in shards)
                 for i in range(3)]
    for sh in shards:
        for a in sh:
            inner = sharded.interior(a, grid.shards[0], -3).clone()
            a.normal_()
            sharded.interior(a, grid.shards[0], -3).copy_(inner)
    sharded.refresh_halos(shards, grid)
    for i in range(3):
        sharded.refresh_halos(per_chain[i], grid)
        for sh, one in zip(shards, per_chain[i]):
            assert all(torch.equal(a[i], b) for a, b in zip(sh, one))
    assert all(torch.equal(a, b) for a, b in
               zip(sharded.gather_links(shards, grid), us))


@pytest.mark.parametrize("kw,mesh,chain_mesh", [
    (dict(SU2, algorithm="metropolis", track_acceptance=True, rng_mode="hw",
          start="hot", seed=4), (2, 2, 1, 1), 2),
    (dict(SU3, track_kp_exhaust=True, seed=2), (2, 1, 1, 1), 1),
], ids=["su2-metro-acc-hw-xy-2blocks", "su3-hb-kp-x"])
def test_each_chain_is_its_sharded_simulation(kw, mesh, chain_mesh):
    """Chain c of a scan on a mesh is its sharded Simulation (seed + 1000 c,
    betas[c], the same mesh), bit for bit: links, series, tracked column.
    Against the unsharded scan its links are bit for bit and its series
    within 1e-6 (f64 shard order)."""
    cfg = SimConfig(**kw)
    betas = BETAS[cfg.group]
    flat = BetaScan(cfg, betas, device="cpu")
    obs_flat = flat.run(2, 1)
    scan = BetaScan(cfg.replace(mesh=mesh), betas, chain_mesh, device="cpu")
    assert scan.chain_mesh == chain_mesh
    if chain_mesh > 1:
        scan.warmup()
    obs = scan.run(2, 1)
    assert obs.shape == obs_flat.shape == (len(betas), 2,
                                           len(scan.obs_names))
    np.testing.assert_allclose(obs, obs_flat, rtol=0, atol=1e-6)
    assert all(torch.equal(a, b) for a, b in zip(scan.us, flat.us))
    for c, beta in enumerate(scan.betas):
        sim = Simulation(cfg.replace(mesh=mesh, seed=cfg.seed + 1000 * c,
                                     beta=float(beta)), device="cpu")
        np.testing.assert_array_equal(obs[c], sim.run(2, 1))
        assert all(torch.equal(a[c], b) for a, b in zip(scan.us, sim.us))
    assert ((obs[..., -1] >= 0) & (obs[..., -1] <= 1)).all()


def test_chain_blocks_change_no_chain():
    """chain_mesh 2 (also with its blocks on devices ["cpu", "cpu"]) is
    chain_mesh 1, bit for bit, on a mesh; each block holds its own chains'
    couplings and keys."""
    cfg = SimConfig(**SU2, mesh=(2, 1, 1, 1), n_or=1, start="hot", seed=9)
    runs = []
    for chain_mesh, devices in ((1, None), (2, None), (2, ["cpu", "cpu"])):
        scan = BetaScan(cfg, BETAS[2][:2], chain_mesh, device="cpu",
                        devices=devices)
        runs.append((scan.run(2, 1), scan.us))
    blocks = scan._st
    assert len(blocks) == 2 and blocks[1][1].tolist() == [
        float(np.float32(BETAS[2][1]))]
    assert torch.equal(blocks[1][2], keys_tensor(scan.keys[1:], "cpu"))
    for obs, us in runs[1:]:
        np.testing.assert_array_equal(obs, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(us, runs[0][1]))


def test_chain_lattice_matches_reference():
    """From the same cold start and seeds, the port's chain x lattice scan
    (mesh (2,1,1,1), 2 blocks) and the reference's (its XLA tier on 2 x 2
    of the conftest's 8 virtual CPU devices) agree to
    test_scan_matches_reference's bars."""
    kw = dict(SU2, beta=2.3, seed=3, mesh=(2, 1, 1, 1))
    betas = BETAS[2][:2]
    ref = RefBetaScan(RefConfig(**kw, engine="xla"), betas, chain_mesh=2)
    assert set(ref._cmesh.axis_names) == {"c", "x", "y", "z", "t"}
    obs_ref = np.asarray(ref.run(2, 1))
    obs = BetaScan(SimConfig(**kw), betas, 2, device="cpu").run(2, 1)
    assert obs.shape == obs_ref.shape == (2, 2, 6)
    np.testing.assert_allclose(obs[:, 0, :4], obs_ref[:, 0, :4], atol=5e-5)
    np.testing.assert_allclose(obs[:, 0, 4:], obs_ref[:, 0, 4:], atol=2e-4)
    np.testing.assert_allclose(obs, obs_ref, atol=1e-2)


def test_chain_mesh_auto_resolution():
    """Auto (0) takes the largest divisor of C that fits the devices //
    prod(cfg.mesh), as the reference does (tests/test_ensemble_sharded.py
    cases, 8 devices); one card or the CPU gives 1; C that a block count
    does not divide raises."""
    cfg = SimConfig(**SU2)
    assert resolve_chain_mesh(0, cfg, 4, 8) == 4
    assert resolve_chain_mesh(0, cfg, 8, 8) == 8
    assert resolve_chain_mesh(0, cfg, 12, 8) == 6
    assert resolve_chain_mesh(0, cfg, 7, 8) == 7
    assert resolve_chain_mesh(2, cfg, 4, 8) == 2
    assert resolve_chain_mesh(0, cfg.replace(mesh=(2, 1, 1, 1)), 4, 8) == 4
    assert resolve_chain_mesh(0, SimConfig(**{**SU2, "dims": (8, 8, 2, 4)},
                                           mesh=(2, 2, 1, 1)), 4, 8) == 2
    assert resolve_chain_mesh(0, cfg, 11, 1) == 1
    assert BetaScan(cfg, BETAS[2], 0, device="cpu").chain_mesh == 1
    with pytest.raises(ValueError, match="divide evenly"):
        BetaScan(cfg.replace(mesh=(2, 1, 1, 1)), BETAS[2][:3], 2,
                 device="cpu")


def test_chain_mesh_auto_counts_only_the_block_cards(monkeypatch):
    """Auto divides only the cards the blocks spread over: without
    ``devices`` every block sits on the scan's one device, so auto gives 1
    however many cards the host has; with ``devices`` its distinct cards
    count."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    cfg = SimConfig(**SU2)
    assert block_cards(None) == 1
    assert resolve_chain_mesh(0, cfg, 4, block_cards(None)) == 1
    assert block_cards(["cuda:0", "cuda:1", "cuda:1"]) == 2
    assert block_cards(["cpu", "cpu"]) == 1
    cards = [f"cuda:{i}" for i in range(4)]
    assert resolve_chain_mesh(0, cfg, 4, block_cards(cards)) == 4
    assert resolve_chain_mesh(0, cfg.replace(mesh=(2, 1, 1, 1)), 4,
                              block_cards(cards)) == 2
    assert BetaScan(cfg, BETAS[2], 0, device="cpu").chain_mesh == 1
    assert BetaScan(cfg, BETAS[2], 0, device="cpu",
                    devices=["cpu", "cpu"]).chain_mesh == 1


def test_sharded_scan_checkpoint(tmp_path):
    """A scan on (2,2,1,1) in 2 blocks saves the reference's betascan file
    with the global fields: the reference's BetaScan.load reads it, and the
    port resumes it unsharded, on (2,1,1,1) in 1 block and on its own
    layout, each equal to the uninterrupted scan bit for bit (links; the
    series on the same mesh)."""
    cfg = SimConfig(**SU2, mesh=(2, 2, 1, 1), start="hot", seed=5)
    betas = BETAS[2][:2]
    whole = BetaScan(cfg, betas, 2, device="cpu")
    whole.thermalize(1)
    obs_whole = whole.run(1, 1)
    scan = BetaScan(cfg, betas, 2, device="cpu")
    scan.thermalize(1)
    path = str(tmp_path / "scan_state.npz")
    scan.save(path)
    ref = RefBetaScan.load(path)
    assert ref.sweep_idx == 1
    np.testing.assert_array_equal(np.asarray(ref.keys), scan.keys)
    np.testing.assert_array_equal(np.asarray(ref.us), scan.u.numpy())
    for mesh, chain_mesh in ((None, 2), ((1, 1, 1, 1), 1),
                             ((2, 1, 1, 1), 1)):
        back = BetaScan.load(path, chain_mesh, device="cpu", mesh=mesh)
        assert back.cfg.mesh == (mesh or cfg.mesh) and back.sweep_idx == 1
        obs = back.run(1, 1)
        np.testing.assert_allclose(obs, obs_whole, rtol=0, atol=1e-6)
        if mesh is None:
            np.testing.assert_array_equal(obs, obs_whole)
        assert all(torch.equal(a, b) for a, b in zip(back.us, whole.us))


def test_cli_scan_on_a_mesh_then_resume(tmp_path):
    """scan --mesh 2,1,1,1 --chain-mesh 2, 1 + 2 sweeps, then
    --resume-state for 2 more (in one block): series and links equal an
    uninterrupted 1 + 4 scan's."""
    base = ["scan", "--group", "2", "--dims", "4,4,2,4", "--betas",
            "2.1,2.5", "--mesh", "2,1,1,1", "--chain-mesh", "2",
            "--seed", "6", "--reunit-every", "2", "--device", "cpu",
            "--therm", "1"]
    outs = [str(tmp_path / k) for k in "abc"]
    cli.main([*base, "--sweeps", "2", "--out", outs[0]])
    cli.main(["scan", "--resume-state",
              os.path.join(outs[0], "scan_state.npz"), "--sweeps", "2",
              "--chain-mesh", "1", "--device", "cpu", "--out", outs[1]])
    cli.main([*base, "--sweeps", "4", "--out", outs[2]])
    recs = []
    for out in outs[1:]:
        with open(os.path.join(out, "scan.json")) as f:
            recs.append(json.load(f))
    assert recs[0]["config"]["mesh"] == [2, 1, 1, 1]
    for name, series in recs[1]["series"].items():
        assert recs[0]["series"][name] == [s[2:] for s in series]
    (_, _, _, u_b, idx_b), (_, _, _, u_c, idx_c) = (
        load_betascan(os.path.join(out, "scan_state.npz"))
        for out in outs[1:])
    assert idx_b == idx_c == 5
    np.testing.assert_array_equal(u_b, u_c)
