"""K3 plane sums and K4 Polyakov sums — CUDA kernels (csrc/measure.cu) and
their plain PyTorch versions, for SU(3) and SU(2).

Port of qcdgpu_tpu/ops/pallas/measure.py ``plane_sums`` and
``polyakov_sums``.  The per-site values are f32, as in the reference; the
sums over sites are f64 (the H100 has f64, which replaces the reference's
f32 Kahan accumulation across its X grid).

Plane order: (0,1), (0,2), (0,3), (1,2), (1,3), (2,3).
"""

from __future__ import annotations

import torch

from . import build, core

PLANES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# threads per block of the measurement kernels (power of two); the f64
# partials scratch holds one row per block
REDUCE_BLOCK = 256

LAUNCHES = {f"{k}_su{n}": 0 for k in ("plane_sums", "polyakov_sums")
            for n in (3, 2)}


def _check(us, dims):
    if len(us) != 8:
        raise ValueError("us must be the 8-tuple us[2*mu + parity]")
    n = us[0].shape[1]
    if n not in (2, 3):
        raise ValueError(f"packed links are SU(2) or SU(3), got N={n}")
    for i, a in enumerate(us):
        core.check_packed(a, n, dims, f"us[{i}]")
    return n, core.check_device(*us)


def _retrace_ab_dag(a, b):
    """Re tr(a b^+) = sum_{r,c} Re(a_rc conj(b_rc)), f32, reference order."""
    tr = None
    for r in range(len(a)):
        for c in range(len(a)):
            t = a[r][c][0] * b[r][c][0] + a[r][c][1] * b[r][c][1]
            tr = t if tr is None else tr + t
    return tr


def plane_sums_ref(us, dims):
    """f64 [6]: sum over ALL sites of Re tr P for each plane."""
    n, _ = _check(us, dims)
    dims = tuple(dims)
    sums = torch.zeros(6, dtype=torch.float64, device=us[0].device)
    for p in (0, 1):
        ld = core.LinkLoader(us, p, dims, n)
        for k, (mu, nu) in enumerate(PLANES):
            a = core.mmul(ld.U(mu), ld.U(nu, ((mu, 1),)))
            b = core.mmul(ld.U(nu), ld.U(mu, ((nu, 1),)))
            sums[k] += _retrace_ab_dag(a, b).to(torch.float64).sum()
    return sums


def polyakov_sums_ref(us, dims):
    """f64 [2]: (sum re, sum im) over spatial sites of tr prod_t U_t, the
    product walked in t as the kernel walks it."""
    n, _ = _check(us, dims)
    x_dim, y_dim, z_dim, t_dim = dims
    t2 = t_dim // 2
    dev = us[0].device
    v2 = us[6].numel() // (4 * n)
    both = torch.cat([us[6].reshape(4 * n, v2), us[7].reshape(4 * n, v2)],
                     dim=1)
    col = torch.arange(x_dim * y_dim * z_dim, dtype=torch.int64, device=dev)
    z = col % z_dim
    y = (col // z_dim) % y_dim
    x = col // (z_dim * y_dim)
    sig = (x + y + z) % 2

    def link(t):
        idx = ((sig + t) % 2) * v2 + col * t2 + t // 2
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
