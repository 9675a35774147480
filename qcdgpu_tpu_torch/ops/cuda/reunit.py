"""K2: SU(3) reunitarization of one packed array — CUDA kernel
(csrc/reunit.cu) and its plain PyTorch version.

Port of qcdgpu_tpu/ops/pallas/reunit.py for SU(3): Gram–Schmidt on the two
stored rows (row 2 is implicit in the codec).  Site-local, in place.
"""

from __future__ import annotations

import torch

from . import build, core

LAUNCHES = {"reunit": 0}


def _check(s, dims):
    if s.shape[1] != 3:
        raise NotImplementedError(
            "SU(2) reunitarization is not ported yet (ROADMAP queue 1, "
            "SU(2) instantiations of K1 and K2)"
        )
    core.check_packed(s, 3, dims)
    return core.check_device(s)


def _norm_row(r):
    s = None
    for c in r:
        t = c[0] * c[0] + c[1] * c[1]
        s = t if s is None else s + t
    inv = 1.0 / torch.sqrt(s)
    return tuple((c[0] * inv, c[1] * inv) for c in r)


def reunitarize_dir_ref(s, dims):
    """Plain PyTorch version; projects s in place and returns it."""
    _check(s, dims)
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
    """Project one packed (direction, parity) array back onto SU(3), in
    place.  CPU tensors take the plain version, CUDA tensors the kernel."""
    if _check(s, dims) == "cpu":
        return reunitarize_dir_ref(s, dims)
    lib = build.library()
    with torch.cuda.device(s.device):
        err = lib.qg_reunit_su3(s.data_ptr(), s.numel() // 12,
                                build.stream_handle(s.device))
    build.check(err, "reunit_su3")
    LAUNCHES["reunit"] += 1
    return s
