"""Build and load the hand-written CUDA kernels (csrc/*.cu).

All kernels are compiled by ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, loaded with ``ctypes``:

    build/qcdgpu_tpu_torch/libqcdgpu_kernels-<sha>.so

under the checkout root, where <sha> hashes the sources and the flags, so
an edited source gets a fresh library and an unchanged one is reused.  Each
source compiles to an object in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links them.  The build happens at first use
(``library()``), never at import, and raises if ``nvcc`` is missing or
fails: there is no fallback.

``-fmad=false`` keeps every f32 operation rounding as in the plain PyTorch
versions (no multiply-add contraction), and ``--use_fast_math`` is not
used, so sqrt and division are IEEE.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_DIR / "csrc"
# K1's Philox build, its stream families and the chain-batched K1c and
# K1ac get a source each, so that their instantiations compile in parallel
# with the rest
SOURCES = ("stage.cu", "stage_philox.cu", "stage_chains.cu",
           "stage_chains_sharded.cu", "reunit.cu", "measure.cu") + tuple(
    f"stage_{fam}.cu" for fam in ("xor128", "xor7", "mrg32k3a", "parkmiller",
                                  "constant", "ranlux", "ranmar"))
HEADERS = ("common.cuh", "stage.cuh", "streams.cuh")
BUILD_DIR = PACKAGE_DIR.parent / "build" / "qcdgpu_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C entry point -> argtypes; every entry point returns a cudaError_t as int
SIGNATURES = {
    "qg_stage": [_P] * 8 + [_I] * 9 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_float, _I, _I,
        ctypes.c_float, _P, _P],
    "qg_stage_philox": [_P] * 8 + [_I] * 9 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_float, _I, _I,
        ctypes.c_float, _P, _P],
    "qg_stage_stream": [_P] * 8 + [_I] * 10 + [
        _P, _I, ctypes.c_uint, _I, _I, ctypes.c_float, _I, _I,
        ctypes.c_float, _P, _P],
    "qg_reunit": [_P, _I, _I, _P],
    "qg_plane_sums": [_P] * 8 + [_I] * 5 + [_P, _P, _P],
    "qg_polyakov_sums": [_P, _P] + [_I] * 6 + [_P, _P, _P],
    "qg_measure_row": [_P] * 8 + [_I] * 5 + [_P] * 4,
    # a shard's geometry: lx, ly, Z, T, hx, hy, x0, y0, global Y
    "qg_stage_shard": [_P] * 8 + [_I] * 14 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_float, _I, _I,
        ctypes.c_float, _P, _P],
    "qg_stage_philox_shard": [_P] * 8 + [_I] * 14 + [
        ctypes.c_uint, ctypes.c_uint, ctypes.c_float, _I, _I,
        ctypes.c_float, _P, _P],
    "qg_stage_stream_shard": [_P] * 8 + [_I] * 15 + [
        _P, _I, ctypes.c_uint, _I, _I, ctypes.c_float, _I, _I,
        ctypes.c_float, _P, _P],
    "qg_plane_sums_local": [_P] * 8 + [_I] * 10 + [_P, _P, _P],
    "qg_polyakov_sums_local": [_P, _P] + [_I] * 11 + [_P, _P, _P],
    # the chain-batched forms: chain stride (floats) and chain count first
    "qg_stage_chains": [_P] * 8 + [_L] + [_I] * 11 + [
        _P, ctypes.c_float, _P, ctypes.c_uint, ctypes.c_uint, _I, _I,
        ctypes.c_float, _P, _P],
    "qg_reunit_chains": [_P, _I, _I, _I, _P],
    "qg_plane_sums_chains": [_P] * 8 + [_L] + [_I] * 6 + [_P, _P, _P],
    "qg_polyakov_sums_chains": [_P, _P, _L] + [_I] * 7 + [_P, _P, _P],
    # the chain-batched forms on a shard (K1ac, K5ac, K5bc)
    "qg_stage_chains_sharded": [_P] * 8 + [_L] + [_I] * 16 + [
        _P, ctypes.c_float, _P, ctypes.c_uint, ctypes.c_uint, _I, _I,
        ctypes.c_float, _P, _P],
    "qg_plane_sums_local_chains": [_P] * 8 + [_L] + [_I] * 11 + [
        _P, _P, _P],
    "qg_polyakov_sums_local_chains": [_P, _P, _L] + [_I] * 12 + [
        _P, _P, _P],
}


def nvcc_path() -> str:
    """nvcc on PATH, else under the CUDA toolkit that PyTorch finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    cand = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if CUDA_HOME and cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libqcdgpu_kernels-{source_hash()}.so"


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    return log


def build() -> dict:
    """Compile the library unless it exists.  Returns {path, seconds,
    log, built}; ``log`` holds nvcc's output (ptxas register and spill
    counts) when it ran."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": out, "seconds": 0.0, "log": log, "built": False}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{source_hash()}.{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:
            logs = list(pool.map(_run, [
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]))
        logs.append(_run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                          "-shared", "-o", str(tmp), *map(str, objs)]))
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    os.replace(tmp, out)
    log_path.write_text(log)
    return {"path": out, "seconds": seconds, "log": log, "built": True}


@lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    lib = ctypes.CDLL(str(build()["path"]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
