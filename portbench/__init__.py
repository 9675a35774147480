"""The benchmark of qcdgpu_tpu_torch on the NVIDIA H100: its harness
(harness.py, run by run.py), the plain reference that decides ``correct``
(reference.py, check.py), the roofline arithmetic (yardstick.py), the
trace reduction (tracing.py), and the data each cell is made of: configs/,
traffic/, limits/, metrics/.  Imports neither jax nor qcdgpu_tpu."""
