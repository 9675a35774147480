"""PRNGCL generator family as per-site stateful streams.

Port of qcdgpu_tpu/ops/prng_streams.py: every lattice site owns an
independent generator state (QCDGPU's PRNGCL keeps one per GPU thread), and
the update kernels advance it in place.  The algorithms are the public ones
of the reference's native library: Luescher RANLUX (luxury 0..4),
Marsaglia RANMAR and XOR128, Panneton-L'Ecuyer XOR7, L'Ecuyer MRG32k3a,
Park-Miller minstd and the CONSTANT debug generator.  Every stream here is
bit-identical to the reference's (tests/test_torch_streams.py).

Two layouts of the same state:

* dense: a dict with the reference's keys and one array per state word over
  the lattice ``[*dims]`` (``make_stream_state``, ``stream_draw``).  The lag
  generators are stored "rolled-canonical" (the walking pointer at its
  seeding slot); the hot start draws in this layout;
* words: one stacked tensor ``[W, *sites]`` (``state_to_words``), the layout
  of the stage kernel.  The lag window of ranlux/ranmar is mutated in
  ABSOLUTE slots there, addressed by a walking pointer; the pointer,
  ranlux's luxury counter ``nb`` and ranmar's carry ``c`` are site- and
  seed-independent and ride beside the words as host Python numbers
  (``stream_kernel_scalars`` / ``advance_kernel_scalars``), so a sweep
  never waits for the device.

Storage: 32-bit unsigned words are kept in int32 tensors holding the same
bits (torch's uint32 lacks most operators); the plain versions compute in
int64 masked to 32 bits, as ops/rng.py does.  Ranmar and constant words
are f32.  ``draw_words`` is the plain version of the stage kernel's
in-register draws (csrc/streams.cuh) and the only place the recurrences
live: the dense draws run it and rotate the lag window back to canonical.
Ranmar's 97 x 24 seeding recurrence runs as torch ops over all sites on the
target device (the reference's per-site numpy loop is slow at 32^4).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import STREAM_GENERATORS, stream_mode_name  # noqa: F401

_M32 = 0xFFFFFFFF
_INV24 = 1.0 / (1 << 24)
_INV32 = 1.0 / 4294967296.0

# the stage kernel's generator families (one CUDA source each); the ranlux
# luxury level is a runtime skip length, not a family
FAMILIES = ("xor128", "xor7", "mrg32k3a", "parkmiller", "constant",
            "ranlux", "ranmar")


def family(name: str) -> str:
    """The kernel family of generator ``name``."""
    _check_name(name)
    return "ranlux" if name.startswith("ranlux") else name


def _check_name(name):
    if name not in STREAM_GENERATORS:
        raise ValueError(f"unknown generator {name!r}; have {STREAM_GENERATORS}")


# ---------------------------------------------------------------------------
# int32 storage of u32 words
# ---------------------------------------------------------------------------


def _u32(w):
    """int32 word tensor -> int64 in [0, 2**32) with the same bits."""
    return w.to(torch.int64) & _M32


def _to_i32(v):
    """int64 in [0, 2**32) -> int32 with the same bits."""
    return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32)


# ---------------------------------------------------------------------------
# seeds and initial states
# ---------------------------------------------------------------------------


def site_seeds(seed: int, dims) -> np.ndarray:
    """Per-site uint64 seeds: splitmix64 over the global site index (1-based),
    row-major over dims (host numpy, as the reference)."""
    n = int(np.prod(dims))
    z = np.uint64(seed & 0xFFFFFFFFFFFFFFFF) + (
        np.arange(1, n + 1, dtype=np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    )
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    z = z ^ (z >> np.uint64(31))
    return z.reshape(tuple(dims))


def _seed_lo_hi(s64):
    return ((s64 & np.uint64(_M32)).astype(np.uint32),
            (s64 >> np.uint64(32)).astype(np.uint32))


def _xor128_init(seed, dims):
    lo, hi = _seed_lo_hi(site_seeds(seed, dims))
    x = np.uint32(123456789) ^ lo
    y = np.uint32(362436069) ^ hi
    z = np.full_like(x, 521288629, np.uint32)
    w = np.uint32(88675123) + lo * np.uint32(2654435761)
    x = np.where((x | y | z | w) == 0, np.uint32(1), x)
    return {"x": x, "y": y, "z": z, "w": w}


def _xor7_init(seed, dims):
    lo, hi = _seed_lo_hi(site_seeds(seed, dims))
    s = (lo ^ hi) | np.uint32(1)
    xs = []
    for _ in range(8):
        s = np.uint32(69069) * s + np.uint32(12345)
        xs.append(s.copy())
    return {"x": np.stack(xs)}  # walking index k = 0 (canonical)


_RANLUX_P = (24, 48, 97, 223, 389)
_RANLUX_PTR0 = 23  # canonical slot of i24 (j24 = i24 - 14 mod 24 = 9)
_RANMAR_PTR0 = 96  # canonical slot of i97 (j97 = i97 - 64 mod 97 = 32)
_RM_CD_I = 7654321   # ranmar carry decrement, in 2^-24 grid units
_RM_CM_I = 16777213  # ranmar carry modulus, in 2^-24 grid units


def ranlux_skip_len(name: str) -> int:
    """SWB steps a ranlux luxury skip discards (0 for ranlux0)."""
    return _RANLUX_P[int(name[-1])] - 24


def _ranlux_init(seed, dims):
    lo, hi = _seed_lo_hi(site_seeds(seed, dims))
    s = lo ^ hi
    s = np.where(s == 0, np.uint32(314159265), s)
    xs = []
    for _ in range(24):
        s = np.uint32(69069) * s + np.uint32(1)
        xs.append(((s >> 8) & np.uint32(0xFFFFFF)).astype(np.int32))
    x = np.stack(xs)
    return {"x": x, "carry": (x[23] == 0).astype(np.int32), "nb": 0}


def _ranmar_init(seed, dims, device):
    """The 97 x 24 Marsaglia-Zaman seeding recurrence, vectorised over the
    sites as int64 torch ops on ``device`` (all values are small, so the
    arithmetic is exact).  Each lag word is 24 bits, first bit of weight
    1/2, accumulated as an integer and scaled by 2^-24 exactly."""
    s64 = site_seeds(seed, dims).ravel()
    ij = (s64 % np.uint64(31329)).astype(np.int64)
    kl = ((s64 // np.uint64(31329)) % np.uint64(30082)).astype(np.int64)

    def dev(a):
        return torch.from_numpy(a).to(device)

    i = dev((ij // 177) % 177 + 2)
    j = dev(ij % 177 + 2)
    k = dev((kl // 169) % 178 + 1)
    ll = dev(kl % 169)
    u = torch.empty((97, s64.size), dtype=torch.float32, device=device)
    for ii in range(97):
        s = torch.zeros_like(i)
        for _ in range(24):
            m = (((i * j) % 179) * k) % 179
            i, j, k = j, k, m
            ll = (53 * ll + 1) % 169
            s = 2 * s + ((ll * m) % 64 >= 32).to(torch.int64)
        u[ii] = s.to(torch.float32) * _INV24
    return {"u": u.reshape((97,) + tuple(dims)),
            "c": 362436.0 / 16777216.0}


_MRG_M1, _MRG_M2 = 4294967087, 4294944443
_MRG_A12, _MRG_A13 = 1403580, 810728
_MRG_A21, _MRG_A23 = 527612, 1370589
_MRG_NORM = float(np.float32(2.328306549295728e-10))  # f32(1/(m1+1))


def _mrg_init(seed, dims):
    z = site_seeds(seed, dims).copy()
    words = []
    for i in range(6):
        z = z + np.uint64(0x9E3779B97F4A7C15)
        t = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        t = (t ^ (t >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        t = t ^ (t >> np.uint64(31))
        m = _MRG_M1 if i < 3 else _MRG_M2
        words.append((np.uint64(1) + t % np.uint64(m - 2)).astype(np.uint32))
    return {"s1": np.stack(words[:3]), "s2": np.stack(words[3:])}


_PM_M, _PM_A, _PM_Q, _PM_R = 2147483647, 16807, 127773, 2836
_PM_NORM = float(np.float32(1.0 / 2147483647.0))


def _parkmiller_init(seed, dims):
    s = (site_seeds(seed, dims) % np.uint64(_PM_M)).astype(np.int32)
    return {"s": np.where(s == 0, np.int32(1), s)}


def _constant_init(seed, dims, value=0.5):
    del seed
    return {"v": np.full(tuple(dims), value, np.float32)}


def make_stream_state(name: str, seed: int, dims, device="cpu") -> dict:
    """The initial per-site stream state (dense layout) on ``device``:
    tensors with the reference's keys (u32 words as int32 bits), and the
    0-d ``nb`` (ranlux) / ``c`` (ranmar) as Python numbers.  Bit-identical
    to the reference's make_stream_state_host."""
    _check_name(name)
    dims = tuple(dims)
    if name == "ranmar":
        return _ranmar_init(seed, dims, device)
    if name.startswith("ranlux"):
        host = _ranlux_init(seed, dims)
    else:
        host = {"xor128": _xor128_init, "xor7": _xor7_init,
                "mrg32k3a": _mrg_init, "parkmiller": _parkmiller_init,
                "constant": _constant_init}[name](seed, dims)
    out = {}
    for k, v in host.items():
        if isinstance(v, np.ndarray):
            if v.dtype == np.uint32:
                v = v.view(np.int32)
            v = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# word layout
# ---------------------------------------------------------------------------


def stream_word_count(name: str) -> int:
    return {"xor128": 4, "xor7": 8, "mrg32k3a": 6, "parkmiller": 1,
            "constant": 1, "ranlux": 25, "ranmar": 97}[family(name)]


def stream_word_dtype(name: str) -> torch.dtype:
    """Storage dtype of the words (u32 words live in int32)."""
    return (torch.float32 if family(name) in ("ranmar", "constant")
            else torch.int32)


def words_to_numpy(name: str, words) -> np.ndarray:
    """Words as numpy in the reference's dtype: the u32 generators' int32
    bits viewed as uint32, the others as stored."""
    a = words.cpu().numpy()
    return a.view(np.uint32) if family(name) in _U32_FAMILIES else a


_U32_FAMILIES = ("xor128", "xor7", "mrg32k3a")


def words_from_numpy(name: str, a, device) -> torch.Tensor:
    """Inverse of words_to_numpy: numpy words in the reference's dtype ->
    the stored tensor on ``device``."""
    a = np.asarray(a)
    want = np.uint32 if family(name) in _U32_FAMILIES else (
        np.int32 if stream_word_dtype(name) == torch.int32 else np.float32)
    if a.dtype != want:
        raise ValueError(f"{name} words: expected {np.dtype(want)}, got "
                         f"{a.dtype}")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def state_to_words(name: str, state) -> torch.Tensor:
    """Dense state dict -> stacked words [W, *site_shape] (new tensor).  For
    the lag generators the window is in the rolled-canonical rotation, which
    is the absolute layout with the pointer at its seeding slot; nb / c are
    not part of the words (stream_kernel_scalars)."""
    fam = family(name)
    if fam == "xor128":
        return torch.stack([state["x"], state["y"], state["z"], state["w"]])
    if fam == "mrg32k3a":
        return torch.cat([state["s1"], state["s2"]])
    if fam == "parkmiller":
        return state["s"][None].clone()
    if fam == "constant":
        return state["v"][None].clone()
    if fam == "ranlux":
        return torch.cat([state["x"], state["carry"][None]])
    return state["x" if fam == "xor7" else "u"].clone()


def words_to_state(name: str, words, scalars=None) -> dict:
    """Inverse of state_to_words; ``scalars`` (the lag generators' only)
    supplies nb / c."""
    fam = family(name)
    if fam == "xor128":
        return {"x": words[0], "y": words[1], "z": words[2], "w": words[3]}
    if fam == "xor7":
        return {"x": words}
    if fam == "mrg32k3a":
        return {"s1": words[:3], "s2": words[3:]}
    if fam == "parkmiller":
        return {"s": words[0]}
    if fam == "constant":
        return {"v": words[0]}
    if fam == "ranlux":
        return {"x": words[:24], "carry": words[24], "nb": scalars["nb"]}
    return {"u": words, "c": scalars["c"]}


# ---------------------------------------------------------------------------
# the scalar channel (host Python numbers)
# ---------------------------------------------------------------------------


def kernel_scalar_names(name: str) -> tuple:
    """Keys of a generator's scalars (stream_kernel_scalars)."""
    return {"ranlux": ("nb", "ptr"), "ranmar": ("c", "ptr")}.get(
        family(name), ())


def stream_kernel_scalars(name: str, state) -> dict:
    """Scalars of a lag generator from a dense (rolled-canonical) state:
    ``ptr`` is the absolute walking-pointer slot, the seeding slot for any
    rolled-canonical state.  {} for the counter-free generators."""
    fam = family(name)
    if fam == "ranlux":
        return {"nb": int(state["nb"]), "ptr": _RANLUX_PTR0}
    if fam == "ranmar":
        return {"c": float(state["c"]), "ptr": _RANMAR_PTR0}
    return {}


def _ranmar_ci(c) -> int:
    """ranmar's carry on its exact 2^-24 integer grid."""
    return int(round(float(c) * (1 << 24)))


def encode_kernel_scalars(name: str, scalars) -> tuple:
    """(s0, ptr0) as the stage kernel takes them: ranlux (nb, ptr); ranmar
    (c * 2^24, ptr), exact; (0, 0) for the counter-free generators."""
    fam = family(name)
    if fam == "ranlux":
        return int(scalars["nb"]), int(scalars["ptr"])
    if fam == "ranmar":
        return _ranmar_ci(scalars["c"]), int(scalars["ptr"])
    return 0, 0


def advance_kernel_scalars(name: str, scalars, n: int) -> dict:
    """The scalars after n >= 1 in-kernel draws, in closed form on Python
    ints (no overflow at any n).  ranlux: nb' = ((nb + n - 1) % 24) + 1,
    skips fired = (nb + n - 1) // 24, each skip costing skip_len SWB steps
    and each draw one, all walking the pointer down.  ranmar: c' = c - n CD
    (mod CM) on the 2^-24 grid; the pointer walks down once per draw."""
    fam = family(name)
    if fam == "ranlux":
        nb = int(scalars["nb"])
        skips = (nb + n - 1) // 24
        return {"nb": (nb + n - 1) % 24 + 1,
                "ptr": (int(scalars["ptr"]) - n
                        - ranlux_skip_len(name) * skips) % 24}
    if fam == "ranmar":
        ci = (_ranmar_ci(scalars["c"]) - n * _RM_CD_I) % _RM_CM_I
        return {"c": ci * _INV24, "ptr": (int(scalars["ptr"]) - n) % 97}
    return {}


# ---------------------------------------------------------------------------
# the draws (plain version of csrc/streams.cuh)
# ---------------------------------------------------------------------------


def _f32(v):
    """int64 tensor -> f32, correctly rounded (the kernel's
    __uint2float_rn / __int2float_rn)."""
    return v.to(torch.float32)


def _xor128(ws, n):
    x, y, z, w = ws
    out = []
    for _ in range(n):
        t = (x ^ (x << 11)) & _M32
        w2 = w ^ (w >> 19) ^ t ^ (t >> 8)
        x, y, z, w = y, z, w, w2
        out.append(_f32(w2) * _INV32)
    return out, [x, y, z, w]


def _xor7(ws, n):
    x = list(ws)  # canonical: the walking index at slot 0
    out = []
    for _ in range(n):
        t = x[7]
        t = (t ^ (t << 13)) & _M32
        y = (t ^ (t << 9)) & _M32
        t = x[4]
        y = y ^ t ^ ((t << 7) & _M32)
        t = x[3]
        y = y ^ t ^ (t >> 3)
        t = x[1]
        y = y ^ t ^ (t >> 10)
        t = x[0]
        t = t ^ (t >> 7)
        y = y ^ t ^ ((t << 24) & _M32)
        x = x[1:] + [y]  # write slot k, advance k: rotate back to k = 0
        out.append(_f32(y) * _INV32)
    return out, x


def _submod(a, b, m):
    return torch.where(a >= b, a - b, a + (m - b))


def _mrg32k3a(ws, n):
    s10, s11, s12, s20, s21, s22 = ws
    out = []
    for _ in range(n):
        # a * s < 2^21 * 2^32: exact in int64, and % is the exact residue
        p1 = _submod((_MRG_A12 * s11) % _MRG_M1, (_MRG_A13 * s10) % _MRG_M1,
                     _MRG_M1)
        p2 = _submod((_MRG_A21 * s22) % _MRG_M2, (_MRG_A23 * s20) % _MRG_M2,
                     _MRG_M2)
        s10, s11, s12, s20, s21, s22 = s11, s12, p1, s21, s22, p2
        z = _submod(p1, p2, _MRG_M1)
        z = torch.where(z == 0, torch.full_like(z, _MRG_M1), z)
        out.append(_f32(z) * _MRG_NORM)
    return out, [s10, s11, s12, s20, s21, s22]


def _parkmiller(ws, n):
    (s,) = ws
    out = []
    for _ in range(n):
        hi = s // _PM_Q  # Schrage: every intermediate below 2^31
        t = _PM_A * (s - hi * _PM_Q) - _PM_R * hi
        s = torch.where(t > 0, t, t + _PM_M)
        out.append(_f32(s) * _PM_NORM)
    return out, [s]


def _ranlux(ws, n, nb, ptr, skip_len):
    x = list(ws[:24])
    carry = ws[24]
    i = ptr % 24
    out = []

    def swb():
        nonlocal carry, i
        d = x[(i + 10) % 24] - x[i] - carry  # j24 = i24 - 14 (mod 24)
        borrow = (d < 0).to(torch.int64)
        d = d + borrow * (1 << 24)
        x[i] = d
        carry = borrow
        i = (i - 1) % 24
        return d

    for _ in range(n):
        if nb == 24:  # luxury skip: discard skip_len values
            for _ in range(skip_len):
                swb()
            nb = 0
        d = swb()
        nb += 1
        out.append(_f32(d) * _INV24)
    return out, x + [carry]


def _ranmar(ws, n, ci, ptr):
    u = list(ws)
    i = ptr % 97
    out = []
    for _ in range(n):
        uni = u[i] - u[(i + 33) % 97]  # j97 = i97 - 64 (mod 97)
        uni = uni + (uni < 0).to(torch.float32)
        u[i] = uni
        i = (i - 1) % 97
        ci = (ci - _RM_CD_I) % _RM_CM_I
        v = uni - ci * _INV24  # both on the 2^-24 grid: exact
        out.append(v + (v < 0).to(torch.float32))
    return out, u


def draw_words(name: str, words, n: int, scalars=None) -> list:
    """n draws from the words ``[W, *sites]`` (stage-kernel layout),
    advancing them IN PLACE; returns the n raw f32 draws [*sites] (on the
    closed [0, 1]: see open01).  ``scalars``: the lag generators' nb / c and
    ptr (stream_kernel_scalars); advance them with advance_kernel_scalars.
    Draw order, state update and rounding are those of the stage kernel."""
    fam = family(name)
    if n <= 0:
        return []
    if fam == "constant":
        return [words[0].clone() for _ in range(n)]
    if fam == "ranmar":
        s0, ptr = encode_kernel_scalars(name, scalars)
        out, new = _ranmar(list(words.unbind(0)), n, s0, ptr)
        words.copy_(torch.stack(new))
        return out
    ws = [_u32(w) for w in words.unbind(0)]
    if fam == "ranlux":
        nb, ptr = encode_kernel_scalars(name, scalars)
        out, new = _ranlux(ws, n, nb, ptr, ranlux_skip_len(name))
    else:
        out, new = {"xor128": _xor128, "xor7": _xor7,
                    "mrg32k3a": _mrg32k3a, "parkmiller": _parkmiller,
                    }[fam](ws, n)
    words.copy_(_to_i32(torch.stack(new)))
    return out


def stream_draw(name: str, state, n: int):
    """n draws from a dense state: (uniforms [n, *dims] f32 on [0, 1], the
    advanced state).  The reference's make_stream draw function, with the
    lag window rotated back to canonical after the draws."""
    words = state_to_words(name, state)
    scal = stream_kernel_scalars(name, state)
    out = draw_words(name, words, n, scal)
    if scal:
        scal2 = advance_kernel_scalars(name, scal, n)
        nlag, ptr0 = (24, _RANLUX_PTR0) if family(name) == "ranlux" \
            else (97, _RANMAR_PTR0)
        # canonical slot i = absolute slot (i + ptr - ptr0) mod nlag
        perm = [(i + scal2["ptr"] - ptr0) % nlag for i in range(nlag)]
        idx = torch.tensor(perm + list(range(nlag, words.shape[0])),
                           device=words.device)
        words = words.index_select(0, idx)
        return torch.stack(out), words_to_state(name, words, scal2)
    return torch.stack(out), words_to_state(name, words)


def open01(u):
    """Clamp draws into the open (0, 1) for the samplers: the 24-bit-grid
    generators emit exact zeros and the modulus-division ones can round to
    exactly 1.0; 2^-24 is the grid spacing, so at most one grid point
    moves."""
    return torch.clamp(u, _INV24, 1.0 - _INV24)
