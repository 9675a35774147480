"""K8's index schedule: the lag-window generators of the stage kernel
(csrc/streams.cuh Ranlux and Ranmar), their slot arithmetic copied below
in plain Python ints, against the plain twins prng_streams._ranlux and
_ranmar on a few sites.

Ranlux keeps its 24-word window, carry, pointer and luxury counter in
absolute slots (the thread's column of shared memory in the kernel) and,
as each subgroup starts, makes all the draws the subgroup takes into the
column for the sampler to read.  Its draws step the window one slot at a
time; a luxury skip runs in registers: the window loaded in the canonical
rotation (word k from slot (i - k) mod 24), whole 24-step blocks on
static slots, the remainder (skip mod 24: 0, 0, 1, 7, 5 for levels 0-4)
on static slots too, and the window stored back under the pointer it was
loaded at.  Ranmar stages the n + 33 slots a stage of n draws reads (all
97 past n = 64) at the relative index o = (ptr0 + 33 - slot) mod 97, so
draw t reads o = t + 33 and o = t and writes o = t + 33, and stores the
written slots back once.

Every ptr0 and luxury counter nb0 in 0..24 is covered for each level and
draw count n: case (level, n) runs nb0 = 0..24 with ptr0 = (5 nb0 + 7 level
+ n) mod 24, which takes all 24 pointers (the full product would take
the torch twin about 90 s).  Ranmar runs every ptr0 in 0..96 for each n.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from qcdgpu_tpu_torch.ops import prng_streams as ps
from qcdgpu_tpu_torch.ops.cuda import update as cupdate

torch.set_num_threads(1)

SITES = 2
NS = (4, 18, 54, 100)
# draws a subgroup takes at each stage draw count: SU(2) Metropolis with
# one hit (4), SU(2) heat-bath (18), SU(3) heat-bath (3 subgroups of 18),
# SU(2) Metropolis with 25 hits (100)
PER = {4: 4, 18: 18, 54: 18, 100: 100}
# the skip remainders (skip mod 24) luxury_skip runs on static slots
KERNEL_REMAINDERS = (0, 1, 5, 7)
STREAMS_CUH = (Path(__file__).resolve().parents[1] / "qcdgpu_tpu_torch"
               / "csrc" / "streams.cuh")
# Ranlux's chunk: the most draws of a subgroup its column holds at once
MAX_PER = int(re.search(r"kMaxPer = (\d+);", STREAMS_CUH.read_text())[1])
# subgroups past one chunk: SU(3) Metropolis with 110 hits (440 draws, two
# chunks) and SU(2) heat-bath with 210 KP trials (842 draws, three)
LONG = ((2 * 440, 440), (842, 842))


def lag24(i, k):
    """(i - k) mod 24 for i in [0, 24), 0 <= k < 24 (streams.cuh lag24)."""
    s = i - k
    return s + 24 if s < 0 else s


class RanluxKernel:
    """One site's ranlux as the kernel runs it, on Python ints."""

    def __init__(self, words, nb0, ptr0, skip, per):
        self.w = list(words[:24])  # absolute slots
        self.carry = words[24]
        self.i, self.nb, self.skip, self.per = ptr0, nb0, skip, per
        self.drawn, self.q, self.left = [], 0, 0

    def swb(self):
        """One step at the pointer i, j = i - 14 (mod 24)."""
        i = self.i
        j = i - 14 if i >= 14 else i + 10
        d = self.w[j] - self.w[i] - self.carry
        self.carry = (d & 0xFFFFFFFF) >> 31
        d &= 0xFFFFFF
        self.w[i] = d
        self.i = 23 if i == 0 else i - 1
        return d

    def luxury_skip(self):
        """The skip in registers: r[k] = slot (i0 - k); step t of a block
        writes r[t] from r[t + 14] (static slots); a whole block is a lag
        cycle, so r[k] is slot (i0 - k) again after it."""
        i0 = self.i
        r = [self.w[lag24(i0, k)] for k in range(24)]

        def steps(m):
            for t in range(m):
                d = r[(t + 14) % 24] - r[t] - self.carry
                self.carry = (d & 0xFFFFFFFF) >> 31
                r[t] = d & 0xFFFFFF

        for _ in range(self.skip // 24):
            steps(24)
        rem = self.skip % 24
        assert rem in KERNEL_REMAINDERS, self.skip
        steps(rem)
        for k in range(24):
            self.w[lag24(i0, k)] = r[k]
        self.i = lag24(i0, rem)

    def make_chunk(self, skip_in_registers):
        """The next chunk of at most MAX_PER of the subgroup's draws: the
        skip in registers as a subgroup starts, stepped one slot at a time
        for a refill inside the sampler."""
        n = min(self.left, MAX_PER)
        self.drawn, self.q = [], 0
        for _ in range(n):
            if self.nb == 24:
                if skip_in_registers:
                    self.luxury_skip()
                else:
                    for _ in range(self.skip):
                        self.swb()
                self.nb = 0
            self.drawn.append(self.swb())
            self.nb += 1
        self.left -= n

    def subgroup(self):
        """The subgroup's draws (its first chunk), made as it starts."""
        self.left = self.per
        self.make_chunk(True)

    def next(self):
        if self.q == MAX_PER:  # a subgroup past MAX_PER draws
            self.make_chunk(False)
        d = self.drawn[self.q]
        self.q += 1
        return d

    def words(self):
        return self.w + [self.carry]


def ranlux_draws(words, n, nb0, ptr0, skip, per):
    g = RanluxKernel(words, nb0, ptr0, skip, per)
    out = []
    for t in range(n):
        if t % per == 0:
            g.subgroup()
        out.append(g.next())
    return out, g.words()


def ranmar_draws(words, n, ci, ptr0):
    """One site's ranmar as the kernel runs it: the staged slots at the
    relative index, the carry on the 2^-24 grid (words and draws as f32
    on numpy, exact: every value is on the grid)."""
    f32 = np.float32
    m = min(n + 33, 97)
    b = [f32(0)] * 97
    s = ptr0 + 33 - 97 if ptr0 + 33 >= 97 else ptr0 + 33
    for o in range(m):
        b[o] = words[s]
        s = 96 if s == 0 else s - 1
    oi, oj, out = 33, 0, []
    for _ in range(n):
        uni = f32(b[oi] - b[oj])
        uni = f32(uni + (f32(1) if uni < 0 else f32(0)))
        b[oi] = uni
        oi = 0 if oi == 96 else oi + 1
        oj = 0 if oj == 96 else oj + 1
        ci -= 7654321
        if ci < 0:
            ci += 16777213
        v = f32(uni - f32(ci) * f32(2.0 ** -24))
        out.append(f32(v + (f32(1) if v < 0 else f32(0))))
    new = list(words)
    s, o = ptr0, 33
    for _ in range(min(n, 97)):
        new[s] = b[o]
        s = 96 if s == 0 else s - 1
        o = 0 if o == 96 else o + 1
    return out, new


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("level", range(5))
def test_ranlux_schedule(level, n):
    gen = f"ranlux{level}"
    skip = ps.ranlux_skip_len(gen)
    rng = np.random.default_rng(100 * level + n)
    for nb0 in range(25):
        ptr0 = (5 * nb0 + 7 * level + n) % 24
        w = rng.integers(0, 1 << 24, size=(25, SITES), dtype=np.int64)
        w[24] = rng.integers(0, 2, size=SITES)
        twin_out, twin_words = ps._ranlux(
            [torch.from_numpy(r.copy()) for r in w], n, nb0, ptr0, skip)
        for s in range(SITES):
            got, words = ranlux_draws([int(v) for v in w[:, s]], n, nb0,
                                      ptr0, skip, PER[n])
            case = (gen, n, nb0, ptr0, s)
            assert [float(u[s]) for u in twin_out] == [
                d * 2.0 ** -24 for d in got], case
            assert [int(v[s]) for v in twin_words] == words, case


@pytest.mark.parametrize("n,per", LONG)
@pytest.mark.parametrize("level", range(5))
def test_ranlux_chunked_schedule(level, n, per):
    """Subgroups of more draws than a chunk: the kernel makes them MAX_PER
    at a time, the refill stepping its luxury skips one slot at a time, and
    the words are draw_words' (the plain twin's) whatever the length."""
    gen = f"ranlux{level}"
    skip = ps.ranlux_skip_len(gen)
    rng = np.random.default_rng(1000 * level + per)
    for nb0, ptr0 in ((23, 5), (24, 14)):
        w = rng.integers(0, 1 << 24, size=(25, 1), dtype=np.int64)
        w[24] = rng.integers(0, 2, size=1)
        twin_out, twin_words = ps._ranlux(
            [torch.from_numpy(r.copy()) for r in w], n, nb0, ptr0, skip)
        got, words = ranlux_draws([int(v) for v in w[:, 0]], n, nb0, ptr0,
                                  skip, per)
        case = (gen, n, per, nb0, ptr0)
        assert [float(u[0]) for u in twin_out] == [
            d * 2.0 ** -24 for d in got], case
        assert [int(v[0]) for v in twin_words] == words, case


@pytest.mark.parametrize("n", NS)
def test_ranmar_schedule(n):
    rng = np.random.default_rng(n)
    for ptr0 in range(97):
        u = (rng.integers(0, 1 << 24, size=(97, SITES))
             * 2.0 ** -24).astype(np.float32)
        ci = int(rng.integers(0, 16777213))
        twin_out, twin_words = ps._ranmar(
            [torch.from_numpy(r.copy()) for r in u], n, ci, ptr0)
        for s in range(SITES):
            got, words = ranmar_draws(list(u[:, s]), n, ci, ptr0)
            case = (n, ptr0, s)
            assert [float(v[s]) for v in twin_out] == [
                float(g) for g in got], case
            assert [float(v[s]) for v in twin_words] == [
                float(v) for v in words], case


def test_ranlux_kernel_limits():
    """What the kernel can run: every level's skip remainder is one that
    luxury_skip knows, a column still holds 413 draws (a chunk) and fits a
    block's dynamic shared memory with its head words, and the stages past
    it (103 KP trials, 104 Metropolis hits: 414 and 416 draws a subgroup)
    are no longer refused: the CUDA wrapper has no such check, and the
    chunked instantiation makes their draws in two chunks."""
    assert {ps.ranlux_skip_len(f"ranlux{lv}") % 24
            for lv in range(5)} <= set(KERNEL_REMAINDERS)
    src = STREAMS_CUH.read_text()
    head = max(int(h) for h in re.search(
        r"kHead = kChunked \? (\d+) : (\d+);", src).groups())
    assert MAX_PER == 413
    assert (head + MAX_PER) * 128 * 4 <= 227 * 1024
    assert not hasattr(cupdate, "check_stream_kernel")
    for kind, k_trials, n_hit in (("heatbath", 103, 1),
                                  ("metropolis", 1, 104)):
        per = cupdate.uniforms_per_subgroup(kind, k_trials, n_hit)
        assert per > MAX_PER
        words = [(7 * k + 3) & 0xFFFFFF for k in range(24)] + [1]
        twin_out, twin_words = ps._ranlux(
            [torch.tensor([v]) for v in words], per, 5, 11, 199)
        got, new = ranlux_draws(words, per, 5, 11, 199, per)
        assert [float(u[0]) for u in twin_out] == [
            d * 2.0 ** -24 for d in got]
        assert [int(v[0]) for v in twin_words] == new
