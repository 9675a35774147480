"""SU(N) algebra on complex fields with matrix indices LEADING.

Port of qcdgpu_tpu/ops/sun.py for SU(2) and SU(3): the field algebra
(products, traces, reunitarization) that the start states, the extended
observables and the dense engine use, and the SU(2) quaternion and
Cabibbo–Marinari subgroup helpers of the dense engine's samplers
(ops/samplers.py).  A field is a complex tensor ``[N, N, *sites]``;
products are elementwise over the sites, so that site dimensions stay
contiguous.  Complex64 and complex128 fields alike.
"""

from __future__ import annotations

import torch


def cmul(a, b):
    """The elementwise product of two complex tensors, with per element the
    same bits whatever the tensors' layout.  On the CPU torch rounds its
    vectorized complex product otherwise than the scalar one it takes on
    a strided view or a short row, so that a shard's interior and the
    whole lattice would differ in the last bit; there the product goes
    through real operations, each rounded once.  On the card torch's own
    product, one expression for every layout."""
    if a.device.type != "cpu":
        return a * b
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(ar * br - ai * bi, ar * bi + ai * br)


def mul(a, b):
    """Matrix product over the leading matrix dims of two [N, N, *sites]
    fields: the outer product of column j of a and row j of b for every
    (i, k) at once, summed over j in the reference's order of terms (the
    same elementwise products and sums as its unrolled loop, in 2N - 1
    launches)."""
    cols = a.unsqueeze(2).unbind(1)  # column j of a as [N, 1, *sites]
    rows = b.unsqueeze(0).unbind(1)  # row j of b as [1, N, *sites]
    acc = cmul(cols[0], rows[0])
    for j in range(1, a.shape[1]):
        acc = acc + cmul(cols[j], rows[j])
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
    nrm = torch.sqrt(torch.sum(torch.real(cmul(r, torch.conj(r))), dim=0))
    return r / nrm


def cross3(u, v):
    """Complex cross product of two [3, *sites] row fields."""
    return torch.stack(
        [
            cmul(u[1], v[2]) - cmul(u[2], v[1]),
            cmul(u[2], v[0]) - cmul(u[0], v[2]),
            cmul(u[0], v[1]) - cmul(u[1], v[0]),
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
    r1 = a[1] - cmul(torch.sum(cmul(torch.conj(r0), a[1]), dim=0), r0)
    r1 = _normalize_row(r1)
    r2 = torch.conj(cross3(r0, r1))
    return torch.stack([r0, r1, r2], dim=0)


def identity(n, site_dims, dtype=torch.complex64, device="cpu"):
    """Unit field [N, N, *site_dims] (a broadcast view; clone to write)."""
    eye = torch.eye(n, dtype=dtype, device=device)
    return eye.reshape((n, n) + (1,) * len(site_dims)).expand(
        (n, n) + tuple(site_dims))


# ---------------------------------------------------------------------------
# SU(2) quaternions ([4, *sites] real) and the Cabibbo–Marinari subgroups
# (reference ops/sun.py:162-249).  ``*sites`` is any shape: the dense
# engine's fields put a beta scan's chain axis there, before the lattice
# axes, so the same helpers update every chain at once.
# ---------------------------------------------------------------------------


def quat_mul(p, q):
    """Quaternion product matching M(p) @ M(q) = M(quat_mul(p, q)).  The
    16 products p_a q_b come from one broadcast multiply, then are summed
    in the reference's order (r0 = p0 q0 - p1 q1 - p2 q2 - p3 q3; the
    vector part p0 qv + q0 pv - pv x qv), the same values."""
    pq = [t.unbind(0) for t in (p.unsqueeze(1) * q.unsqueeze(0)).unbind(0)]
    return torch.stack([
        pq[0][0] - pq[1][1] - pq[2][2] - pq[3][3],
        pq[0][1] + pq[1][0] - (pq[2][3] - pq[3][2]),
        pq[0][2] + pq[2][0] - (pq[3][1] - pq[1][3]),
        pq[0][3] + pq[3][0] - (pq[1][2] - pq[2][1]),
    ], dim=0)


def quat_mul0(p, q):
    """quat_mul(p, q)[0] alone, the same terms."""
    d0, d1, d2, d3 = (p * q).unbind(0)
    return d0 - d1 - d2 - d3


def quat_conj(q):
    """Conjugate (the inverse of a unit quaternion; M(q)^dag)."""
    q0, q1, q2, q3 = q.unbind(0)
    return torch.stack([q0, -q1, -q2, -q3], dim=0)


def quat_norm2(q):
    """|q|^2, the components' squares summed in order."""
    q0, q1, q2, q3 = q.unbind(0)
    return q0 * q0 + q1 * q1 + q2 * q2 + q3 * q3


def quat_norm(q):
    return torch.sqrt(quat_norm2(q))


def subgroups(n):
    """The SU(2) subgroup index pairs swept by Cabibbo–Marinari."""
    if n == 2:
        return ((0, 1),)
    if n == 3:
        return ((0, 1), (0, 2), (1, 2))
    return tuple((i, j) for i in range(n) for j in range(i + 1, n))


def extract_block_quat(w, i, j):
    """Project the (i, j) 2x2 block of a [N, N, *sites] field onto a
    quaternion [4, *sites]: Re tr(u_emb W) = 2 (u * q)_0 + const."""
    return torch.stack([
        0.5 * (w[i, i].real + w[j, j].real),
        0.5 * (w[i, j].imag + w[j, i].imag),
        0.5 * (w[i, j].real - w[j, i].real),
        0.5 * (w[i, i].imag - w[j, j].imag),
    ], dim=0)


def subgroup_left_mul(q, i, j, m):
    """embed(M(q); rows/cols i, j) @ m for a [N, N, *sites] field m, as a
    new field: only rows i and j change (8 complex products a site).  q is
    real in m's real dtype; M(q)'s entries q0 + i q3 etc. are exact."""
    u00 = torch.complex(q[0], q[3])
    u01 = torch.complex(q[2], q[1])
    u10 = torch.complex(-q[2], q[1])
    u11 = torch.complex(q[0], -q[3])
    rows = list(m.unbind(0))
    rows[i] = cmul(u00, m[i]) + cmul(u01, m[j])
    rows[j] = cmul(u10, m[i]) + cmul(u11, m[j])
    return torch.stack(rows, dim=0)
