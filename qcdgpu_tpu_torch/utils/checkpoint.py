"""Full-state checkpoint / exact resume — port of qcdgpu_tpu/utils/checkpoint.py.

Read/write-compatible with the JAX package in both directions: a
checkpoint written by either package loads in the other.  With
counter-based RNG (threefry, and "hw": Philox here, the TPU's hardware
PRNG there) the RNG state is (seed, sweep_idx), which the config header
and ``sweep_idx`` carry; a PRNGCL stream run adds its per-site generator
state under the ``rngstream__`` prefix.

Two formats, as in the reference:

* a single ``.npz`` holding the canonical field as ``links_ri`` (float
  [2 (re/im), 4, N, N, X, Y, Z, T]) beside the header;
* the packed DIRECTORY (``layout = packed_eo2row``): one ``links_pk_{k}.npy``
  per engine array ``us[k]`` and ``meta.npz`` (header and stream state),
  written last into a ``.tmp`` directory that is swapped in whole, so an
  interrupted save never looks like a checkpoint.  ``Simulation.save``
  writes this one: the port always holds the packed state.

A beta scan (models/ensemble.py BetaScan) writes the reference's
``betascan`` .npz (qcdgpu_tpu/models/ensemble.py:515-583): ``kind =
betascan``, the header, ``betas`` (f32 [C]), ``keys`` (u32 [C, 2], each
chain's base key), ``us_ri`` (the canonical fields as float [2, C, 4, N,
N, X, Y, Z, T]), ``sweep_idx`` and, for a stream scan, the chains' stream
state under the same prefix; ``save_betascan`` / ``load_betascan`` /
``load_betascan_streams``.
``load_state`` refuses it, as the reference does.

Arrays travel as numpy; a tensor argument is copied to the host first.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from ..config import SimConfig
from ..ops.measure import obs_names

FORMAT_VERSION = 1

# npz key prefix for PRNGCL stream-state entries (rng_mode='prngcl:<gen>')
RNG_STREAM_PREFIX = "rngstream__"
PACKED_LAYOUT = b"packed_eo2row"


def _host(a) -> np.ndarray:
    """numpy view of an array or a tensor (copied off the device)."""
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def pack_rng_stream(rng_stream) -> dict:
    """Stream-state dict -> prefixed npz entries ({} when None)."""
    if rng_stream is None:
        return {}
    return {f"{RNG_STREAM_PREFIX}{k}": _host(v) for k, v in rng_stream.items()}


def unpack_rng_stream(z) -> dict | None:
    """Inverse of pack_rng_stream over an open npz file (None if absent)."""
    return {
        k[len(RNG_STREAM_PREFIX):]: z[k]
        for k in z.files
        if k.startswith(RNG_STREAM_PREFIX)
    } or None


def links_to_host(u) -> np.ndarray:
    """Complex link field -> float [2 (re/im), ...] (the ``links_ri``
    entry)."""
    u = _host(u)
    return np.stack([u.real, u.imag])


def links_from_host(ri: np.ndarray, cdtype=np.complex64) -> np.ndarray:
    """Inverse of links_to_host."""
    return (ri[0] + 1j * ri[1]).astype(cdtype)


def save_state(path, cfg: SimConfig, u, sweep_idx: int, obs_history=None,
               rng_stream=None, us=None):
    """Write a checkpoint: the canonical complex field ``u`` as a single
    .npz, or (``us``, the packed 8-tuple; pass exactly one) the packed
    directory.  rng_stream: the PRNGCL per-site generator state for
    rng_mode='prngcl:<gen>' runs, None for counter-based modes."""
    if (u is None) == (us is None):
        raise ValueError("pass exactly one of u (canonical) or us (packed)")
    obs = (
        np.concatenate([_host(o) for o in obs_history], axis=0)
        if obs_history
        else np.zeros((0, len(obs_names(cfg))), np.float32)
    )
    extras = pack_rng_stream(rng_stream)
    header = dict(
        version=np.int64(FORMAT_VERSION),
        config_json=np.bytes_(json.dumps(cfg.to_dict()).encode()),
        sweep_idx=np.int64(sweep_idx),
        obs=obs,
    )
    if us is not None:
        tmp = str(path) + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        for k, a in enumerate(us):
            np.save(os.path.join(tmp, f"links_pk_{k}.npy"), _host(a))
        np.savez(os.path.join(tmp, "meta.npz"), layout=np.bytes_(PACKED_LAYOUT),
                 **header, **extras)
        # commit-then-swap: the previous checkpoint stays at the canonical
        # path until the new one is complete
        old = str(path) + ".old"
        _remove(old)
        if os.path.exists(path):
            os.replace(path, old)
        os.replace(tmp, path)
        _remove(old)
    else:
        # atomic single-file save: numpy appends .npz when missing, so
        # resolve the final name first, write a sibling tmp, then replace
        final = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
        tmp = final + ".tmp.npz"
        np.savez_compressed(tmp, links_ri=links_to_host(u), **header, **extras)
        os.replace(tmp, final)


def _remove(path):
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)


def _read_header(z):
    version = int(z["version"])
    if version != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {version}")
    if "kind" in z.files and bytes(z["kind"]) != b"simulation":
        raise ValueError(
            f"not a Simulation checkpoint "
            f"(kind={bytes(z['kind']).decode()!r}; use `scan "
            "--resume-state` for BetaScan states)"
        )
    cfg = SimConfig.from_dict(json.loads(bytes(z["config_json"]).decode()))
    return cfg, int(z["sweep_idx"]), z["obs"], unpack_rng_stream(z)


def load_state(path):
    """Returns (cfg, state, sweep_idx, history, rng_stream) as numpy; state
    is the canonical complex field, or the packed 8-tuple for a packed
    checkpoint (callers distinguish by isinstance(state, tuple)).  Accepts
    both formats, and packed single-.npz files."""
    if os.path.isdir(path):
        meta_path = os.path.join(path, "meta.npz")
        if not os.path.exists(meta_path):
            raise ValueError(
                f"{path!r} is a directory without meta.npz — not a "
                "checkpoint (or an interrupted save; a valid save writes "
                "meta.npz last)"
            )
        with np.load(meta_path, allow_pickle=False) as z:
            cfg, sweep_idx, obs, rng_stream = _read_header(z)
        u = tuple(np.load(os.path.join(path, f"links_pk_{k}.npy"))
                  for k in range(8))
    else:
        with np.load(path, allow_pickle=False) as z:
            cfg, sweep_idx, obs, rng_stream = _read_header(z)
            cdtype = (np.complex128 if cfg.dtype == "complex128"
                      else np.complex64)
            if "links_ri" in z.files:
                u = links_from_host(z["links_ri"], cdtype)
            else:
                u = tuple(z[f"links_pk_{k}"] for k in range(8))
    history = [obs] if obs.size else []
    return cfg, u, sweep_idx, history, rng_stream


BETASCAN_KIND = b"betascan"


def save_betascan(path, cfg: SimConfig, betas, keys, u, sweep_idx: int,
                  rng_stream=None):
    """Write a beta scan's state as the reference's ``betascan`` .npz (".npz"
    appended when missing, as numpy does): betas [C], base keys [C, 2],
    the canonical complex fields u [C, 4, N, N, X, Y, Z, T] (float32, or
    float64 for complex128), and a stream scan's chain-stacked dense
    stream state (rng_stream, the reference's layout).  Written to a
    sibling file first and moved into place."""
    final = str(path) if str(path).endswith(".npz") else str(path) + ".npz"
    tmp = final + ".tmp.npz"
    np.savez_compressed(
        tmp,
        version=np.int64(FORMAT_VERSION),
        kind=np.bytes_(BETASCAN_KIND),
        config_json=np.bytes_(json.dumps(cfg.to_dict()).encode()),
        betas=np.asarray(_host(betas), np.float32),
        keys=np.asarray(_host(keys), np.uint32),
        us_ri=links_to_host(u).astype(
            np.float64 if cfg.dtype == "complex128" else np.float32),
        sweep_idx=np.int64(sweep_idx),
        **pack_rng_stream(rng_stream),
    )
    os.replace(tmp, final)


def load_betascan(path):
    """Returns (cfg, betas f32 [C], keys u32 [C, 2], u complex [C, 4, N,
    N, X, Y, Z, T], sweep_idx) of a ``betascan`` .npz written by either
    package; refuses other kinds."""
    with np.load(path, allow_pickle=False) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"unsupported version {version}")
        kind = bytes(z["kind"]) if "kind" in z.files else b"simulation"
        if kind != BETASCAN_KIND:
            raise ValueError(
                f"not a BetaScan checkpoint (kind={kind.decode()!r}; use "
                "`resume` for single-chain Simulation states)")
        cfg = SimConfig.from_dict(json.loads(bytes(z["config_json"]).decode()))
        cdtype = np.complex128 if cfg.dtype == "complex128" else np.complex64
        return (cfg, np.asarray(z["betas"], np.float32),
                np.asarray(z["keys"], np.uint32),
                links_from_host(z["us_ri"], cdtype), int(z["sweep_idx"]))


def load_betascan_streams(path):
    """The stream state of a ``betascan`` .npz (numpy, the reference's
    chain-stacked layout), or None for a counter-based scan."""
    with np.load(path, allow_pickle=False) as z:
        return unpack_rng_stream(z)
