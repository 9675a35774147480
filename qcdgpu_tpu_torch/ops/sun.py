"""SU(N) algebra on complex fields with matrix indices LEADING.

Port of the parts of qcdgpu_tpu/ops/sun.py that the port's hot start,
``Simulation.unitarity_defect`` and the extended observables use, for
SU(2) and SU(3).  A field is a complex tensor ``[N, N, *sites]``; products
are elementwise over the sites, so that site dimensions stay contiguous.
"""

from __future__ import annotations

import torch


def mul(a, b):
    """Matrix product over the leading matrix dims of two [N, N, *sites]
    fields: the outer product of column j of a and row j of b for every
    (i, k) at once, summed over j in the reference's order of terms (the
    same elementwise products and sums as its unrolled loop, in 2N - 1
    launches)."""
    acc = a[:, 0, None] * b[None, 0]
    for j in range(1, a.shape[1]):
        acc = acc + a[:, j, None] * b[None, j]
    return acc


def dagger(a):
    """Hermitian conjugate."""
    return torch.conj(a.transpose(0, 1)).resolve_conj()


def trace(a):
    """Complex trace over the leading matrix dims (the diagonal summed in
    order, as the reference does)."""
    acc = a[0, 0]
    for i in range(1, a.shape[0]):
        acc = acc + a[i, i]
    return acc


def retrace(a):
    """Re tr(a)."""
    return torch.real(trace(a))


def det(a):
    """Determinant for N in {2, 3} ([N, N, *sites])."""
    n = a.shape[0]
    if n == 2:
        return a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]
    if n == 3:
        return (
            a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
            - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
            + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0])
        )
    raise NotImplementedError(f"det for N={n}")


def identity_like(a):
    n = a.shape[0]
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    return eye.reshape((n, n) + (1,) * (a.ndim - 2)).expand(a.shape)


def unitarity_defect(a):
    """max |U U^dag - I| over the field, as a 0-d real tensor."""
    d = mul(a, dagger(a)) - identity_like(a)
    return torch.max(torch.abs(d))


def _normalize_row(r):
    """r: [N, *sites] complex -> unit norm along the leading dim."""
    nrm = torch.sqrt(torch.sum(torch.real(r * torch.conj(r)), dim=0))
    return r / nrm


def cross3(u, v):
    """Complex cross product of two [3, *sites] row fields."""
    return torch.stack(
        [
            u[1] * v[2] - u[2] * v[1],
            u[2] * v[0] - u[0] * v[2],
            u[0] * v[1] - u[1] * v[0],
        ],
        dim=0,
    )


def mat_to_quat(m):
    """Project a [2, 2, *sites] complex field onto quaternion form
    [4, *sites] (exact inverse of quat_to_mat on SU(2))."""
    return torch.stack([
        0.5 * (m[0, 0].real + m[1, 1].real),
        0.5 * (m[0, 1].imag + m[1, 0].imag),
        0.5 * (m[0, 1].real - m[1, 0].real),
        0.5 * (m[0, 0].imag - m[1, 1].imag),
    ], dim=0)


def quat_to_mat(q, dtype=torch.complex64):
    """[4, *sites] real -> [2, 2, *sites] complex SU(2) matrix."""
    m00 = torch.complex(q[0], q[3])
    m01 = torch.complex(q[2], q[1])
    m10 = torch.complex(-q[2], q[1])
    m11 = torch.complex(q[0], -q[3])
    return torch.stack([torch.stack([m00, m01]), torch.stack([m10, m11])]
                       ).to(dtype)


def reunitarize(a):
    """Project a near-SU(N) field back to SU(N).  SU(3): Gram–Schmidt on
    rows 0-1, row 2 = conj(r0 x r1), so det = +1 exactly.  SU(2):
    quaternion projection, renormalised."""
    n = a.shape[0]
    if n == 2:
        q = mat_to_quat(a)
        q = q / torch.sqrt(torch.sum(q * q, dim=0))
        return quat_to_mat(q, a.dtype)
    if n != 3:
        raise ValueError(f"reunitarize: SU(2) or SU(3), got N={n}")
    r0 = _normalize_row(a[0])
    r1 = a[1] - torch.sum(torch.conj(r0) * a[1], dim=0) * r0
    r1 = _normalize_row(r1)
    r2 = torch.conj(cross3(r0, r1))
    return torch.stack([r0, r1, r2], dim=0)
