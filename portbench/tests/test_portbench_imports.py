"""The import check: jax, jaxlib, flax and the JAX package are caught by
their whole top-level name; the port, whose name begins with the JAX
package's, passes.  The harness and its reference load neither."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.harness import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("names, found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["qcdgpu_tpu"], ["qcdgpu_tpu"]),
    (["qcdgpu_tpu.ops.pallas"], ["qcdgpu_tpu"]),
    (["qcdgpu_tpu_torch", "qcdgpu_tpu_torch.ops.cuda.engine"], []),
    (["jaxtyping", "flaxen", "qcdgpu"], []),
])
def test_whole_top_level_names(names, found):
    assert forbidden_modules(names) == found


def test_harness_loads_no_jax():
    """Importing every module of the harness, the reference and the port
    (what a run loads) leaves no forbidden module in sys.modules."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.harness, portbench.calibrate, "
            "qcdgpu_tpu_torch, qcdgpu_tpu_torch.models; "
            "from portbench.harness import forbidden_modules; "
            "print(forbidden_modules(sys.modules))" % str(ROOT))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-S", "-c", code],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    if out.returncode != 0 and "No module named" in out.stderr:
        # without site-packages (-S) torch may be missing: rerun with them
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, env=env,
                             timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "check.py", "yardstick.py", "tracing.py",
                 "cells.py"):
        tree = ast.parse((ROOT / "portbench" / name).read_text())
        mods = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods.add(node.module.split(".")[0])
        assert not mods & {"qcdgpu_tpu", "qcdgpu_tpu_torch", "jax",
                           "chip_smoke", "bench", "tools"}, (name, mods)


def test_no_card_no_result(tmp_path):
    """Without a card (this machine's CPU build), or in a checkout that
    holds only BENCHMARK.json and portbench/, run.py exits non-zero and
    prints no result."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "su3_32.hb_hw",
         "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
