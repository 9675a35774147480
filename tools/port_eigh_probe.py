"""Which batch sizes torch.linalg.eigh takes for 3x3 complex64 Hermitian
matrices on a CUDA card, its time per matrix, the memory a call takes
(cuSOLVER's workspace, allocated through PyTorch), and whether two calls
give the same bits, then one APE step at SU(3) 32^4 at several chunk
sizes: the numbers behind ops/smear.py's EIGH_CHUNK.

    python3 tools/port_eigh_probe.py
"""
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def probe(batch, reps=10):
    a = torch.randn(batch, 3, 3, dtype=torch.complex64, device="cuda")
    h = a.mH @ a
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ev, v = torch.linalg.eigh(h)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
        t0 = time.perf_counter()
        for _ in range(reps):
            ev2, v2 = torch.linalg.eigh(h)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / reps
        same = torch.equal(v, v2) and torch.equal(ev, ev2)
        ape = ms * 4 * 32 ** 4 / batch
        print(f"{batch}: ok, {ms:.3f} ms a call, {ms / batch * 1e6:.2f} ns "
              f"a matrix ({ape:.1f} ms for an APE step's 4 x 32^4), peak "
              f"{peak:.1f} MiB during a call, two calls bit-identical "
              f"{same}", flush=True)
    except RuntimeError as e:
        print(f"{batch}: refused: {str(e)[:80]}", flush=True)


def ape_step_by_chunk(chunks, L=32):
    """One APE step (ops/smear.py ape_smear_step) on a hot SU(3) L^4
    field at each EIGH_CHUNK: ms (CUDA events, mean of 3 after a warm-up
    call) and the peak above the field."""
    from qcdgpu_tpu_torch import SimConfig
    from qcdgpu_tpu_torch.ops import rng, smear
    from qcdgpu_tpu_torch.ops.cuda import engine

    dims = (L,) * 4
    cfg = SimConfig(group=3, dims=dims)
    u = engine.join_links(
        engine.packed_hot_start(cfg, rng.make_base_key(1), "cuda"), dims)
    ref = None
    for chunk in chunks:
        smear.EIGH_CHUNK = chunk
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = smear.ape_smear_step(u, 0.5)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(3):
            smear.ape_smear_step(u, 0.5)
        end.record()
        end.synchronize()
        ref = out if ref is None else ref
        d = float(torch.max(torch.abs(out - ref)))
        print(f"APE step at SU(3) {L}^4, EIGH_CHUNK {chunk}: "
              f"{start.elapsed_time(end) / 3:.3f} ms, peak {peak:.3f} GiB "
              f"above the field, max |d| to the first chunk's {d:.1e}",
              flush=True)


def main():
    torch.manual_seed(0)
    print(torch.cuda.get_device_name(0), "torch", torch.__version__,
          "cuda", torch.version.cuda)
    for batch in (512, 1024, 2048, 4096, 8192, 16384, 16385, 32768):
        probe(batch)
    ape_step_by_chunk((16384, 4096, 2048, 1024, 16384))


if __name__ == "__main__":
    main()
