"""Recovery across a change of topology: the counterpart of
``bench/fault_injection_multihost.py``.

    python -m srcdsp_tpu_torch.dist.fault_injection_multihost --device cpu
    python -m srcdsp_tpu_torch.dist.fault_injection_multihost --device cuda

Two ranks (``dist.launch``; gloo, 4 time shards each) stream the pre-filter
and channelizer pipeline (``dist.halo.fir_time_sharded_stream`` ->
``dist.channelize.channelize_time_sharded_stream``) over 3 of 6 buffers,
gather each buffer's bank onto rank 0, which writes it, and checkpoint the
carried tails after every buffer with ``checkpoint.save_orbax`` (every rank
takes part; the tails are replicated). Then they exit, as if the slice were
lost. This process restores the checkpoint on a fresh one-process mesh of 8
shards and finishes the stream. Exit status 0 only if the stitched output
equals one uninterrupted single-device run (``channelize_full(fir_full(x))``,
``torch.equal``).
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

NPROC, SHARDS, M, NBUF, STOP_AFTER, PRE_TAPS = 2, 4, 16, 6, 3, 48


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m srcdsp_tpu_torch.dist.fault_injection_multihost")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--work", default=None, help="work directory (default: a temporary one)")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def pieces(dev: torch.device):
    """(pre-filter taps, channelizer prototype, its padded length, the whole
    stream): seeded, the same in every process."""
    from srcdsp_tpu_torch.chains.channelizer import design_prototype, pad_prototype
    from srcdsp_tpu_torch.dist.multihost_check import noise
    from srcdsp_tpu_torch.ops.window import lowpass

    proto = design_prototype(M, taps_per_phase=4)
    x = torch.as_tensor(noise(3, NBUF * 8 * M * 16), device=dev)
    return (torch.as_tensor(lowpass(PRE_TAPS, 0.45), device=dev), proto,
            int(pad_prototype(proto, M).shape[0]), x)


def fresh_state(tproto: int, dev: torch.device) -> tuple:
    return (torch.zeros(PRE_TAPS - 1, dtype=torch.complex64, device=dev),
            torch.zeros(tproto - 1, dtype=torch.complex64, device=dev))


def buffer_step(pre, proto, state, shards, mesh):
    """One buffer through the sharded pipeline: (new state, bank shards)."""
    from srcdsp_tpu_torch.dist.channelize import channelize_time_sharded_stream
    from srcdsp_tpu_torch.dist.halo import fir_time_sharded_stream

    tail_f, y = fir_time_sharded_stream(pre, state[0], shards, mesh)
    tail_c, banks = channelize_time_sharded_stream(proto, state[1], y, M, mesh)
    return (tail_f, tail_c), banks


def worker(a) -> int:
    from srcdsp_tpu_torch import checkpoint
    from srcdsp_tpu_torch.dist import comm
    from srcdsp_tpu_torch.dist.launch import report
    from srcdsp_tpu_torch.dist.mesh import (
        TIME_AXIS, init_multihost, local_shards, make_mesh, process_allgather, sharding,
        time_sharding)
    from srcdsp_tpu_torch.dist.multihost_check import rank_device

    torch.set_num_threads(1)
    dev = rank_device(a.device, a.worker)
    init_multihost(a.init, NPROC, a.worker, "gloo", timeout=a.timeout)
    try:
        mesh = make_mesh(time=NPROC * SHARDS, devices=[dev] * SHARDS)
        pre, proto, tproto, x = pieces(dev)
        n = x.shape[-1] // NBUF
        spec, rows = time_sharding(mesh), sharding(mesh, TIME_AXIS, 0)
        per = n // spec.num_shards
        state = fresh_state(tproto, dev)
        work = Path(a.work)
        ms = []
        for b in range(STOP_AFTER):
            t0 = time.perf_counter()
            xb = x[b * n + spec.indices[0] * per: b * n + (spec.indices[-1] + 1) * per]
            state, banks = buffer_step(pre, proto, state, local_shards(xb, mesh, spec), mesh)
            bank = process_allgather(banks, rows)
            if mesh.rank == 0:
                np.save(work / f"buf{b}.npy", bank.cpu().numpy())
            checkpoint.save_orbax(str(work / "ckpt"), state, b + 1)
            ms.append((time.perf_counter() - t0) * 1e3)
        report(rank=a.worker, buffers=STOP_AFTER, ms=ms, staged=dict(comm.STAGED))
    finally:
        torch.distributed.destroy_process_group()
    return 0


def start(device: str, work: Path, timeout: float):
    """Start the two ranks that stream, checkpoint and exit."""
    from srcdsp_tpu_torch.dist import launch

    argv = ["--device", device, "--work", str(work), "--timeout", str(timeout)]
    return launch.start("srcdsp_tpu_torch.dist.fault_injection_multihost", NPROC, argv, work,
                        timeout, tag="fault")


def resume(run, device: str) -> dict:
    """Wait for the ranks, restore their checkpoint in this process on a
    one-process mesh of NPROC*SHARDS shards and finish the stream:
    {"ok", "start", "stitched", "reference", "reports", "seconds", "error"}."""
    from srcdsp_tpu_torch import checkpoint
    from srcdsp_tpu_torch.chains.channelizer import channelize_full
    from srcdsp_tpu_torch.dist import launch
    from srcdsp_tpu_torch.dist.mesh import make_mesh, shard, unshard
    from srcdsp_tpu_torch.dist.multihost_check import rank_device
    from srcdsp_tpu_torch.ops.fir import fir_full

    codes, texts = launch.finish(run)
    reps = [launch.reports(t) for t in texts]
    if any(codes) or not all(reps):
        return dict(ok=False, error=launch.failure(codes, texts, "fault injection"))
    t0 = time.perf_counter()
    dev = rank_device(device, 0)
    mesh = make_mesh(time=NPROC * SHARDS, devices=[dev] * (NPROC * SHARDS))
    pre, proto, tproto, x = pieces(dev)
    n = x.shape[-1] // NBUF
    state, start_at = checkpoint.restore_orbax(str(run.work / "ckpt"), fresh_state(tproto, dev))
    outs = [torch.as_tensor(np.load(run.work / f"buf{b}.npy"), device=dev)
            for b in range(start_at)]
    for b in range(start_at, NBUF):
        state, banks = buffer_step(pre, proto, state, shard(x[b * n:(b + 1) * n], mesh), mesh)
        outs.append(unshard(banks, dev, dim=0))
    got = torch.cat(outs, dim=-1)
    ref = channelize_full(proto, fir_full(pre, x), M)
    return dict(ok=bool(torch.equal(got, ref)), start=start_at, stitched=got, reference=ref,
                reports=[r[0] for r in reps], seconds=time.perf_counter() - t0, error=None)


def main(argv=None) -> int:
    a = parse(argv)
    if a.worker is not None:
        return worker(a)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(a.work or tmp)
        res = resume(start(a.device, work, a.timeout), a.device)
    if not res["ok"]:
        print(res["error"] or "recovered stream != uninterrupted single-device run",
              file=sys.stderr)
        return 1
    print(f"multihost fault injection: {NPROC}-process slice lost after buffer "
          f"{res['start']}, one-process recovery equal to the uninterrupted run "
          f"(torch.equal), {res['seconds']:.1f} s to resume", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
