"""Counter-based, site-keyed random numbers (threefry2x32-20, and
Philox-4x32-10 for rng_mode "hw").

Port of qcdgpu_tpu/ops/rng.py, bit for bit:

  bits(site, slot) = threefry2x32(stage_key, (global_site_index, slot))
  stage_key        = threefry2x32(base_key, (sweep_index, stage_id))

rng_mode "hw" selects the TPU's hardware PRNG in the reference, which no
other machine reproduces (the reference calls it "statistically
equivalent, NOT bit-compatible", ops/pallas/core.py:164-167).  The port
draws Philox-4x32-10 (Salmon et al., SC'11; Random123's philox4x32) there,
keyed by the same stage key, with threefry's slot numbering:

  block(site, b) = philox4x32(stage_key, (global_site_index, b, 0, 0))
  slot s         = words 2 (s & 1), 2 (s & 1) + 1 of block(site, s >> 1)

so uniforms 4b .. 4b+3 of a site are block b's four words, and the chain
is a function of (seed, sweep index, site) as with threefry.

Three forms of the same function:

* ``threefry2x32`` works on int64 tensors holding u32 values (torch's CPU
  ``uint32`` has no shift operators); every result is masked back to 32
  bits.
* ``threefry2x32_i32`` works on int32 tensors holding the u32 bits: the
  adds wrap, the rotations mask the sign bits that an arithmetic right
  shift brings in.  The same bits with half the bytes and fewer
  operations; ``site_uniforms`` draws with it.
* ``threefry2x32_host`` works on Python ints.  Keys (``make_base_key``,
  ``stage_key``) are computed on the host with it and handed to the kernels
  as two ints, so deriving a stage key costs no device round trip.

No ``torch.Generator`` is used anywhere: a run's randomness is a pure
function of (seed, sweep index, stage id, site, slot).
"""

from __future__ import annotations

import math

import torch

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

# f32 scale of the 24-bit uniform grid (exact power of two)
_INV_2_24 = 1.0 / (1 << 24)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 on int64 tensors (or ints) holding u32 values.

    Arguments broadcast; returns a pair of int64 tensors in [0, 2**32).
    """
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    inject = 0
    for r in range(20):
        x0 = (x0 + x1) & _M32
        x1 = _rotl(x1, _ROT[r % 8])
        x1 = x1 ^ x0
        if (r + 1) % 4 == 0:
            inject += 1
            x0 = (x0 + ks[inject % 3]) & _M32
            x1 = (x1 + ks[(inject + 1) % 3] + inject) & _M32
    return x0, x1


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m, x):
    """(hi, lo) 32-bit halves of the 64-bit product m * x (m a u32 int, x
    u32 values), in 16-bit limbs so that no partial product leaves int64."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _M32
    hi = ((p_hi + (p_lo >> 16)) >> 16) & _M32
    return hi, lo


def philox4x32(k0, k1, c0, c1, c2, c3):
    """10-round Philox-4x32 on int64 tensors (or ints) holding u32 values.

    Key (k0, k1) ints; counter words broadcast; returns four int64 tensors
    (or ints) in [0, 2**32)."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox4x32_host(k0: int, k1: int, c0: int, c1: int, c2: int, c3: int):
    """philox4x32 on Python ints (u32 values) -> 4 ints."""
    return philox4x32(*(int(v) & _M32 for v in (k0, k1, c0, c1, c2, c3)))


def threefry2x32_host(k0: int, k1: int, x0: int, x1: int):
    """threefry2x32 on Python ints (u32 values) -> (int, int)."""
    return threefry2x32(int(k0) & _M32, int(k1) & _M32,
                        int(x0) & _M32, int(x1) & _M32)


def make_base_key(seed: int):
    """(k0, k1) u32 pair, as Python ints, from a Python int seed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    # pi digits — arbitrary domain constant (same as the reference)
    return threefry2x32_host(s & _M32, s >> 32, 0x243F6A88, 0x85A308D3)


def stage_key(base_key, sweep_idx: int, stage_id: int):
    """Per-(sweep, stage) derived key, as a pair of Python ints."""
    return threefry2x32_host(base_key[0], base_key[1], sweep_idx, stage_id)


def _i32(v):
    """u32 value(s) (an int, or an int64 tensor) -> the same bits as int32
    (an int in the int32 range, or an int32 tensor)."""
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.int32:
            return v
        return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32)
    v = int(v) & _M32
    return v - (1 << 32) if v > 0x7FFFFFFF else v


def _rotl32(x, r):
    """Rotate the u32 bits of an int32 tensor left by r."""
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32_i32(k0, k1, x0, x1):
    """threefry2x32 on int32 tensors holding u32 bits, two's-complement
    wrapping adds: the same bits as threefry2x32.  Keys: u32 ints, or int64
    tensors of u32 values that broadcast with the counters (one key per
    chain); counters x0, x1: int32 tensors.  Returns two int32 tensors."""
    if isinstance(k0, torch.Tensor):
        ks = [_i32(k) for k in (k0, k1, k0 ^ k1 ^ _PARITY)]
    else:
        ks = [int(k0) & _M32, int(k1) & _M32]
        ks.append(ks[0] ^ ks[1] ^ _PARITY)
    x0 = x0 + _i32(ks[0])
    x1 = x1 + _i32(ks[1])
    inject = 0
    for r in range(20):
        x0 = x0 + x1
        x1 = _rotl32(x1, _ROT[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            inject += 1
            x0 = x0 + _i32(ks[inject % 3])
            x1 = x1 + _i32(ks[(inject + 1) % 3] + inject)
    return x0, x1


def bits_to_uniform(bits):
    """u32 (in int64, or its bits in int32) -> f32 in the OPEN interval
    (0, 1), 24-bit grid.

    The +0.5 is added in f32 (it rounds for h >= 2**23), as the reference
    does."""
    h = bits >> 8
    if bits.dtype == torch.int32:
        h = h & 0xFFFFFF
    return (h.to(torch.float32) + 0.5) * _INV_2_24


def site_uniforms(key2, site_idx, n, slot0=0):
    """n uniforms per site: f32 [n, *shape] in (0, 1).

    site_idx: int64 tensor of GLOBAL dense site indices (below 2**31).
    Pair p of the
    output comes from counter (site, slot0 + p): b0 -> u[2p], b1 -> u[2p+1].
    key2: the stage key as two ints, or as two int64 tensors of u32 values
    that broadcast with site_idx (one key per chain of a beta scan: keys
    [C, 1, 1, 1, 1] with site_idx [1, X, Y, Z, T]); shape is the broadcast
    of the keys and site_idx.
    """
    npairs = (n + 1) // 2
    k0, k1 = (k if isinstance(k, torch.Tensor) else int(k)
              for k in key2[:2])
    lead = site_idx.ndim
    if isinstance(k0, torch.Tensor):
        lead = max(lead, k0.ndim)
    slots = (torch.arange(npairs, dtype=torch.int32, device=site_idx.device)
             + slot0).reshape((npairs,) + (1,) * lead)
    b0, b1 = threefry2x32_i32(k0, k1, site_idx[None].to(torch.int32), slots)
    u = torch.stack([bits_to_uniform(b0), bits_to_uniform(b1)], dim=1)
    u = u.reshape((2 * npairs,) + tuple(b0.shape[1:]))
    return u[:n]


def site_uniforms_philox(key2, site_idx, n):
    """rng_mode "hw": the first n uniforms per site, f32 [n,
    *site_idx.shape]: uniforms 4b .. 4b+3 are the words of block b =
    philox4x32(key2, (site, b, 0, 0)), so uniforms 2s, 2s+1 are slot s."""
    nblk = (n + 3) // 4
    blk = torch.arange(nblk, dtype=torch.int64, device=site_idx.device
                       ).reshape((nblk,) + (1,) * site_idx.ndim)
    # ten rounds mix the counter words, so every output word has the
    # broadcast shape [nblk, *site_idx.shape]
    words = philox4x32(int(key2[0]), int(key2[1]), site_idx[None], blk, 0, 0)
    u = torch.stack([bits_to_uniform(w) for w in words], dim=1)
    return u.reshape((4 * nblk,) + tuple(site_idx.shape))[:n]


def normals_from_uniforms(u):
    """[2k, ...] uniforms in (0, 1) -> [2k, ...] standard normals
    (Box–Muller, the reference's pairing and ordering)."""
    r = torch.sqrt(-2.0 * torch.log(u[0::2]))
    th = (2.0 * math.pi) * u[1::2]
    return torch.cat([r * torch.cos(th), r * torch.sin(th)], dim=0)


def site_normals(key2, site_idx, n, slot0=0):
    """n standard normals per site via Box–Muller (for hot starts)."""
    m = 2 * ((n + 1) // 2)
    u = site_uniforms(key2, site_idx, m, slot0=slot0)
    return normals_from_uniforms(u)[:n]
