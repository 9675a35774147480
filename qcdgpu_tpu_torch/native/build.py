"""Build the host C++ libraries of native/ with g++ at first use.

Port of qcdgpu_tpu/native/build.py: a plain C ABI loaded with ctypes.  The
shared object goes to ``build/qcdgpu_tpu_torch/lib<name>-<sha>.so`` under
the checkout root (git-ignored), where <sha> hashes the sources and flags,
so an edited source gets a fresh library; a build writes a temporary file
and renames it, so concurrent first uses do not see half a library.  A
failed build makes ``load_lib`` return None: the host generators are an
optional reference, and callers report them as unavailable, as the
reference does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[1] / "build" / "qcdgpu_tpu_torch"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


class NativeBuildError(RuntimeError):
    pass


def build_lib(name: str, sources: list[str]) -> Path:
    """Compile sources (relative to native/) into the library unless it
    exists; returns its path."""
    srcs = [HERE / s for s in sources]
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, *map(str, srcs), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120, check=False)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise NativeBuildError(f"native build failed to launch: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(
            f"g++ failed ({proc.returncode}):\n{proc.stderr[-2000:]}")
    os.replace(tmp, out)
    return out


def load_lib(name: str, sources: list[str]):
    """Build (if needed) and load; a ctypes.CDLL, or None on failure."""
    try:
        return ctypes.CDLL(str(build_lib(name, sources)))
    except (NativeBuildError, OSError):
        return None
