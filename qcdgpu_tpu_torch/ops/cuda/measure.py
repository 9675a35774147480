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

Plane order: (0,1), (0,2), (0,3), (1,2), (1,3), (2,3).
"""

from __future__ import annotations

import numpy as np
import torch

from . import build, core

PLANES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# threads per block of the measurement kernels (power of two); the f64
# partials scratch holds one row per block
REDUCE_BLOCK = 256

LAUNCHES = {f"{k}_su{n}": 0
            for k in ("plane_sums", "polyakov_sums", "plane_sums_local",
                      "polyakov_sums_local")
            for n in (3, 2)}


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


def polyakov_sums_ref(us, dims, shard=None):
    """f64 [2]: (sum re, sum im) over spatial sites of tr prod_t U_t, the
    product walked in t as the kernel walks it (over a shard's interior
    columns with ``shard``)."""
    n, _ = _check(us, dims, shard)
    g = shard or core.whole(dims)
    x_dim, y_dim, z_dim, t_dim = g.interior
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

    def link(t):
        idx = ((sig + t) % 2) * v2 + base + t // 2
        return core.load_mat(both, n, idx)

    prod = link(0)
    for t in range(1, t_dim):
        prod = core.mmul(prod, link(t))
    tr_re, tr_im = prod[0][0]
    for r in range(1, n):
        tr_re = tr_re + prod[r][r][0]
        tr_im = tr_im + prod[r][r][1]
    return torch.stack([tr_re.to(torch.float64).sum(),
                        tr_im.to(torch.float64).sum()])


def _scratch(n_threads, n_out, device):
    n_blocks = -(-n_threads // REDUCE_BLOCK)
    return (torch.empty(n_blocks * n_out, dtype=torch.float64, device=device),
            torch.empty(n_out, dtype=torch.float64, device=device))


def plane_sums(us, dims):
    """f64 [6] plane sums (PLANES order).  CPU tensors take the plain
    version, CUDA tensors the kernel."""
    n, dev_type = _check(us, dims)
    if dev_type == "cpu":
        return plane_sums_ref(us, dims)
    name = f"plane_sums_su{n}"
    lib = build.library()
    x, y, z, t = (int(d) for d in dims)
    dev = us[0].device
    partials, out = _scratch(x * y * z * t, 6, dev)
    with torch.cuda.device(dev):
        err = lib.qg_plane_sums(
            *[a.data_ptr() for a in us], n, x, y, z, t, REDUCE_BLOCK,
            partials.data_ptr(), out.data_ptr(), build.stream_handle(dev),
        )
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def polyakov_sums(us, dims):
    """f64 [2] (sum re, sum im) of tr prod_t U_t over spatial sites.  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    n, dev_type = _check(us, dims)
    if dev_type == "cpu":
        return polyakov_sums_ref(us, dims)
    name = f"polyakov_sums_su{n}"
    lib = build.library()
    x, y, z, t = (int(d) for d in dims)
    dev = us[0].device
    partials, out = _scratch(x * y * z, 2, dev)
    with torch.cuda.device(dev):
        err = lib.qg_polyakov_sums(
            us[6].data_ptr(), us[7].data_ptr(), n, x, y, z, t, REDUCE_BLOCK,
            partials.data_ptr(), out.data_ptr(), build.stream_handle(dev),
        )
    build.check(err, name)
    LAUNCHES[name] += 1
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
    n, dev_type = _check(us, shard.dims, shard)
    if dev_type == "cpu":
        return plane_sums_local_ref(us, shard)
    name = f"plane_sums_local_su{n}"
    lib = build.library()
    dev = us[0].device
    partials, out = _scratch(int(np.prod(shard.interior)), 6, dev)
    with torch.cuda.device(dev):
        err = lib.qg_plane_sums_local(
            *[a.data_ptr() for a in us], n, *shard.kernel_args(),
            REDUCE_BLOCK, partials.data_ptr(), out.data_ptr(),
            build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    return out


def polyakov_sums_local(us, shard):
    """K5b: f64 [2] (sum re, sum im) of tr prod_t U_t over the interior
    columns of one shard (no halo is read; K4 on a shard without halo).
    CPU tensors take the plain version, CUDA tensors the kernel."""
    if core.padded_or_none(shard) is None:
        return polyakov_sums(us, shard.dims)
    n, dev_type = _check(us, shard.dims, shard)
    if dev_type == "cpu":
        return polyakov_sums_local_ref(us, shard)
    name = f"polyakov_sums_local_su{n}"
    lib = build.library()
    dev = us[0].device
    lx, ly, z, _ = shard.interior
    partials, out = _scratch(lx * ly * z, 2, dev)
    with torch.cuda.device(dev):
        err = lib.qg_polyakov_sums_local(
            us[6].data_ptr(), us[7].data_ptr(), n, *shard.kernel_args(),
            REDUCE_BLOCK, partials.data_ptr(), out.data_ptr(),
            build.stream_handle(dev))
    build.check(err, name)
    LAUNCHES[name] += 1
    return out
