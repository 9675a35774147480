"""K2: reunitarization of one packed array — CUDA kernels (csrc/reunit.cu)
and their plain PyTorch version.

Port of qcdgpu_tpu/ops/pallas/reunit.py.  SU(3): Gram–Schmidt on the two
stored rows (row 2 is implicit in the codec).  SU(2): the quaternion of
the stored matrix, renormalised.  Site-local, in place.

K2c ``reunitarize_chains``: the same kernel over one chain-stacked array
``[C, 2, N, 2, X, Y, Z*T/2]`` of a beta scan, chain on the grid's second
axis (the reference vmaps ``_reunit_kernel``, models/ensemble.py:125).
On a scan on an X/Y mesh it takes a shard's chain-stacked padded array
(dims: the padded extents) whole: the projection is site-local, so a halo
slot comes out with its owner's new bits.
"""

from __future__ import annotations

import torch

from ...utils import profile
from . import build, core

LAUNCHES = {f"reunit{c}_su{n}": 0 for c in ("", "_chains") for n in (3, 2)}


def _check(s, dims):
    n = s.shape[1]
    if n not in (2, 3):
        raise ValueError(f"packed links are SU(2) or SU(3), got N={n}")
    core.check_packed(s, n, dims)
    return n, core.check_device(s)


def _norm_row(r):
    s = None
    for c in r:
        t = c[0] * c[0] + c[1] * c[1]
        s = t if s is None else s + t
    inv = 1.0 / torch.sqrt(s)
    return tuple((c[0] * inv, c[1] * inv) for c in r)


def _reunit_su2(s):
    """Quaternion projection + renormalisation (reference reunit.py:28-39)."""
    m = s.reshape(2, 2, 2, -1)
    a0 = 0.5 * (m[0, 0, 0] + m[1, 1, 0])
    a1 = 0.5 * (m[0, 1, 1] + m[1, 0, 1])
    a2 = 0.5 * (m[0, 1, 0] - m[1, 0, 0])
    a3 = 0.5 * (m[0, 0, 1] - m[1, 1, 1])
    inv = 1.0 / torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3)
    a0, a1, a2, a3 = a0 * inv, a1 * inv, a2 * inv, a3 * inv
    core.store_rows(s, (((a0, a3), (a2, a1)), ((-a2, a1), (a0, -a3))), 2)
    return s


def reunitarize_dir_ref(s, dims):
    """Plain PyTorch version; projects s in place and returns it."""
    n, _ = _check(s, dims)
    if n == 2:
        return _reunit_su2(s)
    comps = s.reshape(2, 3, 2, -1)
    m = [tuple((comps[r, j, 0], comps[r, j, 1]) for j in range(3))
         for r in range(2)]
    r0 = _norm_row(m[0])
    ip = None
    for c0, c1 in zip(r0, m[1]):
        t = core.cmul_conj(c1, c0)
        ip = t if ip is None else core.cadd(ip, t)
    r1 = tuple(
        (c1[0] - (ip[0] * c0[0] - ip[1] * c0[1]),
         c1[1] - (ip[0] * c0[1] + ip[1] * c0[0]))
        for c0, c1 in zip(r0, m[1])
    )
    core.store_rows(s, (r0, _norm_row(r1)), 3)
    return s


def reunitarize_dir(s, dims):
    """Project one packed (direction, parity) array back onto SU(N), in
    place.  CPU tensors take the plain version, CUDA tensors the kernel."""
    if profile.ON:
        profile.begin("k2.reunit")
    n, dev = _check(s, dims)
    if dev == "cpu":
        reunitarize_dir_ref(s, dims)
    else:
        name = f"reunit_su{n}"
        lib = build.library()
        with torch.cuda.device(s.device):
            err = lib.qg_reunit(s.data_ptr(), n, s.numel() // (4 * n),
                                build.stream_handle(s.device))
        build.check(err, name)
        LAUNCHES[name] += 1
    if profile.ON:
        profile.end("k2.reunit")
    return s


def reunitarize_chains_ref(s, dims):
    """Plain twin of K2c: reunitarize_dir_ref on each chain's view."""
    core.check_chains((s,), dims, 1)
    for c in range(s.shape[0]):
        reunitarize_dir_ref(s[c], dims)
    return s


def reunitarize_chains(s, dims):
    """K2c: project every chain of one chain-stacked (direction, parity)
    array back onto SU(N), in place, in one launch.  dims are each chain's
    array extents: the lattice's, or a shard's padded ones (``Shard.padded``:
    halo slots are projected as their owners are, to the same bits).  CPU
    tensors take the plain version, CUDA tensors the kernel."""
    if profile.ON:
        profile.begin("k2.reunit")
    _, n, dev = core.check_chains((s,), dims, 1)
    if dev == "cpu":
        reunitarize_chains_ref(s, dims)
    else:
        name = f"reunit_chains_su{n}"
        lib = build.library()
        with torch.cuda.device(s.device):
            err = lib.qg_reunit_chains(
                s.data_ptr(), n, s[0].numel() // (4 * n), s.shape[0],
                build.stream_handle(s.device))
        build.check(err, name)
        LAUNCHES[name] += 1
    if profile.ON:
        profile.end("k2.reunit")
    return s
