"""K3 plane sums and K4 Polyakov sums — CUDA kernels (csrc/measure.cu) and
their plain PyTorch versions, for SU(3) and SU(2).

Port of qcdgpu_tpu/ops/pallas/measure.py ``plane_sums`` and
``polyakov_sums``.  The per-site values are f32, as in the reference; the
sums over sites are f64 (the H100 has f64, which replaces the reference's
f32 Kahan accumulation across its X grid).

K5a ``plane_sums_local`` and K5b ``polyakov_sums_local`` are the same
kernels on one halo-padded shard of an X/Y mesh (a ``core.Shard``; port of
measure.py ``plane_sums_local`` / ``polyakov_sums_local``, the reference's
``_plq_sharded_kernel`` / ``_poly_sharded_kernel``): the sums over the
shard's interior sites, which the caller adds over the shards.

K3c ``plane_sums_chains`` and K4c ``polyakov_sums_chains`` are K3 and K4
over the C chains of a beta scan (chain-stacked arrays ``[C, 2, N, 2, X,
Y, Z*T/2]``; the reference vmaps ``measure_all_split``,
models/ensemble.py:129-131): f64 [C, 6] and [C, 2], one launch pair for
all chains, each chain's row bit-identical to K3 / K4 on its own arrays.
With ``shard`` they are K5ac / K5bc: K5a / K5b over a block of chains of
a scan on an X/Y mesh (the shard's chain-stacked padded arrays; the
reference vmaps the sharded measurement body over each device's chain
block, models/ensemble.py:96-131), each chain's row K5a / K5b's on its
own padded arrays, bit for bit.

``measure_row`` is the whole measurement of one unsharded chain where
``tile_fits``: K3, K4, both second passes and ``obs_base_from_sums`` in one
launch (csrc/measure.cu, head), its f32 row the three-step path's bit for
bit.

Plane order: (0,1), (0,2), (0,3), (1,2), (1,3), (2,3).
"""

from __future__ import annotations

import numpy as np
import torch

from ...utils import profile
from . import build, core

PLANES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# threads per block of the Polyakov kernels (a power of two from 32 to
# 1024; tools/port_kernel_ab.py times 256 and 512, PERF.md), and the block
# K3 is built for (csrc/measure.cu kPlaneThreads); the f64 partials
# scratch holds one row per block.  measure_row runs K4's blocks at
# PLANE_BLOCK: its sums are K4's while the two agree.
POLY_BLOCK = 256
PLANE_BLOCK = 256
# slots of K3's tile (csrc/measure.cu kTileSlots), and the most slot pairs
# of a column that the line after a tile holds
TILE_SLOTS = PLANE_BLOCK // 2
TILE_T2_MAX = 32

LAUNCHES = {f"{k}_su{n}": 0
            for k in ("plane_sums", "polyakov_sums", "plane_sums_local",
                      "polyakov_sums_local", "plane_sums_chains",
                      "polyakov_sums_chains", "plane_sums_local_chains",
                      "polyakov_sums_local_chains", "measure_row")
            for n in (3, 2)}
# measure_row's ticket counters, one per (device, stream): made at 0 once
# (a launch of its own) and left at 0 by every measure_row launch
_TICKETS = {}


def _check(us, dims, shard=None):
    if len(us) != 8:
        raise ValueError("us must be the 8-tuple us[2*mu + parity]")
    n = us[0].shape[1]
    if n not in (2, 3):
        raise ValueError(f"packed links are SU(2) or SU(3), got N={n}")
    ext = dims if shard is None else shard.padded
    for i, a in enumerate(us):
        core.check_packed(a, n, ext, f"us[{i}]")
    return n, core.check_device(*us)


def _retrace_ab_dag(a, b):
    """Re tr(a b^+) = sum_{r,c} Re(a_rc conj(b_rc)), f32, reference order."""
    tr = None
    for r in range(len(a)):
        for c in range(len(a)):
            t = a[r][c][0] * b[r][c][0] + a[r][c][1] * b[r][c][1]
            tr = t if tr is None else tr + t
    return tr


def plane_sums_ref(us, dims, shard=None):
    """f64 [6]: sum over ALL sites of Re tr P for each plane (over a
    shard's interior sites with ``shard``)."""
    n, _ = _check(us, dims, shard)
    dims = tuple(dims)
    sums = torch.zeros(6, dtype=torch.float64, device=us[0].device)
    for p in (0, 1):
        ld = core.LinkLoader(us, p, dims, n, shard)
        for k, (mu, nu) in enumerate(PLANES):
            a = core.mmul(ld.U(mu), ld.U(nu, ((mu, 1),)))
            b = core.mmul(ld.U(nu), ld.U(mu, ((nu, 1),)))
            sums[k] += _retrace_ab_dag(a, b).to(torch.float64).sum()
    return sums


def poly_lanes(t2):
    """(W, m, L) for a column of t2 slot pairs, a function of T alone
    (csrc/measure.cu poly_lanes): slots a lane, lanes holding a unit, and
    lanes a column's group takes (the smallest power of two >= m, so that
    a group never straddles a warp)."""
    w = -(-t2 // 32)
    m = -(-t2 // w)
    return w, m, 1 << (m - 1).bit_length()


def _mmap(fn, m):
    """fn applied to every component tensor of a matrix tuple."""
    return tuple(tuple((fn(c[0]), fn(c[1])) for c in row) for row in m)


def polyakov_columns_ref(us, dims, shard=None):
    """f32 [2, columns]: (re, im) of tr prod_t U_t for each spatial column,
    in (x, y, z) order (a shard's interior columns with ``shard``).

    The product is K4's association (csrc/measure.cu, header), a function
    of T alone: slot pairs V_s = U_2s U_2s+1, units of W pairs walked left
    to right (W = 1 for T/2 <= 32), the doubling ladder over the units,
    lad_j(k) = lad_{j-1}(k) lad_{j-1}(k + 2^(j-1)), and for each set bit j
    of the unit count m, low to high, the chunk lad_j(pos_j) multiplying
    the lower chunks' product from the left.  The kernel runs a column's
    slots on neighbouring lanes, because a column's slots are contiguous
    (one coalesced load a component) and a ladder is log-depth where a
    walk in t is T - 1 dependent products; here the lanes are the slot
    axis of [columns, T/2] tensors, each level one vectorised product."""
    n, _ = _check(us, dims, shard)
    g = shard or core.whole(dims)
    x_dim, y_dim, z_dim, t_dim = g.interior
    t2 = t_dim // 2
    dev = us[0].device
    v2 = us[6].numel() // (4 * n)
    both = torch.cat([us[6].reshape(4 * n, v2), us[7].reshape(4 * n, v2)],
                     dim=1)
    col = torch.arange(x_dim * y_dim * z_dim, dtype=torch.int64, device=dev)
    z = col % z_dim
    y = (col // z_dim) % y_dim
    x = col // (z_dim * y_dim)
    sig = (x + g.offset[0] + y + g.offset[1] + z) % 2
    base = core.packed_slot(x, y, z, 0, g.interior, g.halo)
    slot = (base[:, None] + torch.arange(t2, device=dev)).reshape(-1)
    par = sig[:, None].expand(-1, t2).reshape(-1)  # t = 2s has parity sig

    def pair_half(p):
        return _mmap(lambda c: c.reshape(-1, t2),
                     core.load_mat(both, n, p * v2 + slot))

    v = core.mmul(pair_half(par), pair_half(1 - par))  # V_s [columns, T/2]
    w, m, _ = poly_lanes(t2)
    unit = _mmap(lambda c: c[:, ::w], v)
    for i in range(1, w):
        k = -(-(t2 - i) // w)  # the units that hold slot k W + i
        step = core.mmul(_mmap(lambda c: c[:, :k], unit),
                         _mmap(lambda c: c[:, i::w], v))
        unit = tuple(tuple((torch.cat([a[0], b[0][:, k:]], 1),
                            torch.cat([a[1], b[1][:, k:]], 1))
                           for a, b in zip(ra, rb))
                     for ra, rb in zip(step, unit))
    lad, acc = unit, None
    for j in range(m.bit_length()):
        if j:
            h, span = 1 << (j - 1), m - (1 << j) + 1
            lad = core.mmul(_mmap(lambda c: c[:, :span], lad),
                            _mmap(lambda c: c[:, h:h + span], lad))
        if m >> j & 1:
            pos = m >> (j + 1) << (j + 1)
            term = _mmap(lambda c: c[:, pos], lad)
            acc = term if acc is None else core.mmul(term, acc)
    tr_re, tr_im = acc[0][0]
    for r in range(1, n):
        tr_re = tr_re + acc[r][r][0]
        tr_im = tr_im + acc[r][r][1]
    return torch.stack([tr_re, tr_im])


def polyakov_sums_ref(us, dims, shard=None):
    """f64 [2]: (sum re, sum im) over spatial sites of tr prod_t U_t, each
    column's loop in K4's association (polyakov_columns_ref; over a shard's
    interior columns with ``shard``)."""
    return polyakov_columns_ref(us, dims, shard).to(torch.float64).sum(1)


def _scratch(n_threads, n_out, device, n_chains=None, block=PLANE_BLOCK):
    """(partials, out): one partials row per block (per chain), and the
    sums, [n_out] (or [n_chains, n_out])."""
    n_blocks = -(-n_threads // block)
    lead = () if n_chains is None else (n_chains,)
    return (torch.empty((n_chains or 1) * n_blocks * n_out,
                        dtype=torch.float64, device=device),
            torch.empty(lead + (n_out,), dtype=torch.float64, device=device))


def plane_sums(us, dims):
    """f64 [6] plane sums (PLANES order).  CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if profile.ON:
        profile.begin("k3.plane_sums")
    n, dev_type = _check(us, dims)
    if dev_type == "cpu":
        out = plane_sums_ref(us, dims)
        if profile.ON:
            profile.end("k3.plane_sums")
        return out
    name = f"plane_sums_su{n}"
    lib = build.library()
    x, y, z, t = (int(d) for d in dims)
    dev = us[0].device
    partials, out = _scratch(x * y * z * t, 6, dev, block=PLANE_BLOCK)
    with torch.cuda.device(dev):
        err = lib.qg_plane_sums(
            *[a.data_ptr() for a in us], n, x, y, z, t, partials.data_ptr(),
            out.data_ptr(), build.stream_handle(dev),
        )
    build.check(err, name)
    LAUNCHES[name] += 1
    if profile.ON:
        profile.end("k3.plane_sums")
    return out


def polyakov_sums(us, dims):
    """f64 [2] (sum re, sum im) of tr prod_t U_t over spatial sites.  CPU
    tensors take the plain version, CUDA tensors the kernel: a group of
    poly_lanes(T/2)[2] lanes per column, lane k on the column's slot k,
    the product in polyakov_columns_ref's association.  The lanes run over
    slots because a column's slots are contiguous: a warp loads
    neighbouring words, and a column's T - 1 products take log2(T/2) + 1
    levels of shuffles, not a chain in one thread."""
    if profile.ON:
        profile.begin("k4.polyakov_sums")
    n, dev_type = _check(us, dims)
    if dev_type == "cpu":
        out = polyakov_sums_ref(us, dims)
        if profile.ON:
            profile.end("k4.polyakov_sums")
        return out
    name = f"polyakov_sums_su{n}"
    lib = build.library()
    x, y, z, t = (int(d) for d in dims)
    dev = us[0].device
    partials, out = _scratch(x * y * z * poly_lanes(t // 2)[2], 2, dev,
                             block=POLY_BLOCK)
    with torch.cuda.device(dev):
        err = lib.qg_polyakov_sums(
            us[6].data_ptr(), us[7].data_ptr(), n, x, y, z, t, POLY_BLOCK,
            partials.data_ptr(), out.data_ptr(), build.stream_handle(dev),
        )
    build.check(err, name)
    LAUNCHES[name] += 1
    if profile.ON:
        profile.end("k4.polyakov_sums")
    return out


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


def tile_fits(dims):
    """Whether K3 runs its tile kernel on the whole lattice of dims
    (csrc/measure.cu tile_fits): whole (z, t) lines fill a tile of
    TILE_SLOTS slots, T/2 <= TILE_T2_MAX.  16^4, 32^4 and 64^4 do; 8^4
    and 24^3 x 6 do not."""
    t2 = int(dims[3]) // 2
    return (t2 <= TILE_T2_MAX and TILE_SLOTS % t2 == 0
            and int(dims[2]) * t2 % TILE_SLOTS == 0)


def _ticket(dev, stream):
    """measure_row's ticket counter for the stream handle ``stream`` of
    dev: launches that share a counter must not overlap, and launches on
    one stream never do."""
    key = (dev, stream)
    if key not in _TICKETS:
        _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=dev)
    return _TICKETS[key]


def measure_row(us, dims):
    """f32 [6]: the standard observables (ops.measure.OBS_NAMES) of one
    unsharded lattice, on the links' device.  CPU tensors take
    obs_base_from_sums of the plain plane and Polyakov sums; CUDA tensors
    one launch (dims must pass tile_fits): K3's tile blocks, then K4's
    column groups, each writing its partial sums, and the last block to
    finish sums them and forms the row, bit for bit obs_base_from_sums of
    plane_sums and polyakov_sums on the card."""
    if profile.ON:
        profile.begin("k3.plane_sums")
    n, dev_type = _check(us, dims)
    if dev_type == "cpu":
        out = obs_base_from_sums(plane_sums_ref(us, dims),
                                 polyakov_sums_ref(us, dims), n, dims)
        if profile.ON:
            profile.end("k3.plane_sums")
        return out
    if not tile_fits(dims):
        raise ValueError(f"measure_row: dims {tuple(dims)} do not tile "
                         f"(tile_fits); use plane_sums and polyakov_sums")
    name = f"measure_row_su{n}"
    lib = build.library()
    x, y, z, t = (int(d) for d in dims)
    dev = us[0].device
    n3 = -(-x * y * z * t // PLANE_BLOCK)
    n4 = -(-x * y * z * poly_lanes(t // 2)[2] // PLANE_BLOCK)
    partials = torch.empty(n3 * 6 + n4 * 2, dtype=torch.float64, device=dev)
    out = torch.empty(6, dtype=torch.float32, device=dev)
    stream = build.stream_handle(dev)
    with torch.cuda.device(dev):
        err = lib.qg_measure_row(
            *[a.data_ptr() for a in us], n, x, y, z, t, partials.data_ptr(),
            _ticket(dev, stream).data_ptr(), out.data_ptr(), stream)
    build.check(err, name)
    LAUNCHES[name] += 1
    if profile.ON:
        profile.end("k3.plane_sums")
    return out


def plane_sums_local_ref(us, shard):
    """Plain twin of K5a: plane_sums_ref over the shard's interior."""
    return plane_sums_ref(us, shard.dims, shard)


def polyakov_sums_local_ref(us, shard):
    """Plain twin of K5b: polyakov_sums_ref over the shard's interior."""
    return polyakov_sums_ref(us, shard.dims, shard)


def plane_sums_local(us, shard):
    """K5a: f64 [6] plane sums over the interior sites of one shard (us its
    halo-padded arrays, halos current; K3 on a shard without halo).  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if core.padded_or_none(shard) is None:
        return plane_sums(us, shard.dims)
    if profile.ON:
        profile.begin("k3.plane_sums")
    n, dev_type = _check(us, shard.dims, shard)
    if dev_type == "cpu":
        out = plane_sums_local_ref(us, shard)
        if profile.ON:
            profile.end("k3.plane_sums")
        return out
    name = f"plane_sums_local_su{n}"
    lib = build.library()
    dev = us[0].device
    partials, out = _scratch(int(np.prod(shard.interior)), 6, dev,
                             block=PLANE_BLOCK)
    with torch.cuda.device(dev):
        err = lib.qg_plane_sums_local(
            *[a.data_ptr() for a in us], n, *shard.kernel_args(),
            partials.data_ptr(), out.data_ptr(),
            build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    if profile.ON:
        profile.end("k3.plane_sums")
    return out


def polyakov_sums_local(us, shard):
    """K5b: f64 [2] (sum re, sum im) of tr prod_t U_t over the interior
    columns of one shard (no halo is read; K4 on a shard without halo).
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if core.padded_or_none(shard) is None:
        return polyakov_sums(us, shard.dims)
    if profile.ON:
        profile.begin("k4.polyakov_sums")
    n, dev_type = _check(us, shard.dims, shard)
    if dev_type == "cpu":
        out = polyakov_sums_local_ref(us, shard)
        if profile.ON:
            profile.end("k4.polyakov_sums")
        return out
    name = f"polyakov_sums_local_su{n}"
    lib = build.library()
    dev = us[0].device
    lx, ly, z, t = shard.interior
    partials, out = _scratch(lx * ly * z * poly_lanes(t // 2)[2], 2, dev,
                             block=POLY_BLOCK)
    with torch.cuda.device(dev):
        err = lib.qg_polyakov_sums_local(
            us[6].data_ptr(), us[7].data_ptr(), n, *shard.kernel_args(),
            POLY_BLOCK, partials.data_ptr(), out.data_ptr(),
            build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    if profile.ON:
        profile.end("k4.polyakov_sums")
    return out


def plane_sums_chains_ref(us, dims, shard=None):
    """Plain twin of K3c (K5ac with ``shard``): plane_sums_ref of each
    chain, f64 [C, 6]."""
    shard = core.padded_or_none(shard)
    c, _, _ = core.check_chains(us, dims, shard=shard)
    return torch.stack([plane_sums_ref(tuple(a[i] for a in us), dims, shard)
                        for i in range(c)])


def polyakov_sums_chains_ref(us, dims, shard=None):
    """Plain twin of K4c (K5bc with ``shard``): polyakov_sums_ref of each
    chain, f64 [C, 2]."""
    shard = core.padded_or_none(shard)
    c, _, _ = core.check_chains(us, dims, shard=shard)
    return torch.stack([polyakov_sums_ref(tuple(a[i] for a in us), dims,
                                          shard)
                        for i in range(c)])


def _chains_call(kind, us, dims, shard, c, n, n_out, threads, block):
    """Launch K3c / K4c (or K5ac / K5bc on a padded shard) over the c
    chains of ``us`` (checked, SU(n)): f64 [C, n_out]; ``threads`` the
    kernel's threads per chain over ``block``-thread blocks."""
    local = "" if shard is None else "_local"
    name = f"{kind}{local}_chains_su{n}"
    lib = build.library()
    dev = us[0].device
    partials, out = _scratch(threads, n_out, dev, c, block)
    links = ([a.data_ptr() for a in us] if kind == "plane_sums"
             else [us[6].data_ptr(), us[7].data_ptr()])
    geom = (tuple(int(d) for d in dims) if shard is None
            else shard.kernel_args())
    tail = () if kind == "plane_sums" else (POLY_BLOCK,)
    with torch.cuda.device(dev):
        err = getattr(lib, f"qg_{kind}{local}_chains")(
            *links, us[0][0].numel(), c, n, *geom, *tail,
            partials.data_ptr(), out.data_ptr(), build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def plane_sums_chains(us, dims, shard=None):
    """K3c: f64 [C, 6] plane sums of every chain of the chain-stacked
    8-tuple; with ``shard`` (a ``core.Shard``: K5ac) over that shard's
    interior sites of every chain's padded arrays.  CPU tensors take the
    plain version, CUDA tensors the kernel."""
    if profile.ON:
        profile.begin("k3.plane_sums")
    shard = core.padded_or_none(shard)
    c, n, dev_type = core.check_chains(us, dims, shard=shard)
    if dev_type == "cpu":
        out = plane_sums_chains_ref(us, dims, shard)
    else:
        g = shard or core.whole(dims)
        out = _chains_call("plane_sums", us, dims, shard, c, n, 6,
                           int(np.prod(g.interior)), PLANE_BLOCK)
    if profile.ON:
        profile.end("k3.plane_sums")
    return out


def polyakov_sums_chains(us, dims, shard=None):
    """K4c: f64 [C, 2] (sum re, sum im) of tr prod_t U_t over spatial sites,
    for every chain; with ``shard`` (K5bc) over that shard's interior
    columns.  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if profile.ON:
        profile.begin("k4.polyakov_sums")
    shard = core.padded_or_none(shard)
    c, n, dev_type = core.check_chains(us, dims, shard=shard)
    if dev_type == "cpu":
        out = polyakov_sums_chains_ref(us, dims, shard)
    else:
        x, y, z, t = (shard or core.whole(dims)).interior
        out = _chains_call("polyakov_sums", us, dims, shard, c, n, 2,
                           x * y * z * poly_lanes(t // 2)[2], POLY_BLOCK)
    if profile.ON:
        profile.end("k4.polyakov_sums")
    return out
