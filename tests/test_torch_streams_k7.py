"""K7's arithmetic as the stage kernel runs it (csrc/streams.cuh): the
mrg32k3a step in f64 (L'Ecuyer's floating-point form), copied below on
Python floats operation by operation with each FMA rounded once, against
exact integer arithmetic (a x - b y) mod m at edge and seeded random
states for both moduli and all four multipliers, and the kernel's
generator so copied against the reference's kernel_stream_draw (JAX, on
the CPU) draw for draw.  numpy has no FMA, so the FMA is the exact
product and sum rounded once to f64 (fractions.Fraction)."""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

from qcdgpu_tpu.ops import prng_streams as ref_ps
from qcdgpu_tpu_torch.ops import prng_streams as ps

M1, M2 = 4294967087, 4294944443
A12, A13 = 1403580, 810728
A21, A23 = 527612, 1370589
# (a, b, m) of each component: p = (a x - b y) mod m
COMPONENTS = ((A12, A13, M1), (A21, A23, M2))
SHIFT = 6755399441055744.0  # 1.5 x 2^52


def fma(a, b, c):
    """IEEE fused multiply-add on f64: the exact a b + c, rounded once."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def mrg_step_f64(a, x, b, y, m):
    """streams.cuh mrg_step on Python floats (f64), each FMA rounded
    once."""
    a, x, b, y, m = (float(v) for v in (a, x, b, y, m))
    p = fma(-b, y, a * x)
    k = fma(p, 1.0 / m, SHIFT) - SHIFT
    r = fma(-k, m, p)
    return int(r + m if r < 0 else r)


def states(m, n, seed):
    """Edge states and n seeded random ones, as (x, y) pairs."""
    edge = (0, 1, 2, m - 2, m - 1)
    rng = np.random.default_rng(seed)
    rand = rng.integers(0, m, size=(n, 2)).tolist()
    return [(x, y) for x in edge for y in edge] + [tuple(p) for p in rand]


@pytest.mark.parametrize("comp", range(2))
def test_mrg_step_is_the_residue(comp):
    a, b, m = COMPONENTS[comp]
    for x, y in states(m, 2000, 7 + comp):
        assert mrg_step_f64(a, x, b, y, m) == (a * x - b * y) % m, (x, y)


def kernel_draws(words, n):
    """One site's mrg32k3a as the kernel runs it: n draws (f32) and the
    new words."""
    s10, s11, s12, s20, s21, s22 = words
    out = []
    for _ in range(n):
        p1 = mrg_step_f64(A12, s11, A13, s10, M1)
        p2 = mrg_step_f64(A21, s22, A23, s20, M2)
        s10, s11, s12, s20, s21, s22 = s11, s12, p1, s21, s22, p2
        z = float(p1) - float(p2)  # exact in f64
        if z <= 0.0:
            z += M1
        out.append(np.float32(z) * np.float32(2.328306549295728e-10))
    return out, [s10, s11, s12, s20, s21, s22]


def test_mrg_kernel_matches_reference():
    """The kernel's draws and words against the reference's
    kernel_stream_draw on seeded sites, one of them with edge words."""
    st = ps.make_stream_state("mrg32k3a", 5, (2, 2, 2, 2))
    w = ps.state_to_words("mrg32k3a", st).reshape(6, -1).numpy()
    w = w.view(np.uint32)[:, :3].copy()
    w[:, 0] = (M1 - 1, 0, M1 - 2, M2 - 1, 1, M2 - 2)
    n = 60
    ref_out, ref_words = ref_ps.kernel_stream_draw(
        "mrg32k3a", [jnp.asarray(r) for r in w], n)
    ref_out = np.stack([np.asarray(u) for u in ref_out])
    ref_words = np.stack([np.asarray(r) for r in ref_words])
    for site in range(w.shape[1]):
        out, words = kernel_draws([int(v) for v in w[:, site]], n)
        np.testing.assert_array_equal(np.array(out, np.float32),
                                      ref_out[:, site])
        assert words == [int(v) for v in ref_words[:, site]]
