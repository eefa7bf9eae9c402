"""Config 5 and the fused front end across processes: the counterpart of
``bench/multihost_check.py``.

    python -m srcdsp_tpu_torch.dist.multihost_check --nproc 2 --device cpu
    python -m srcdsp_tpu_torch.dist.multihost_check --nproc 3 --device cpu   # 12 shards
    python -m srcdsp_tpu_torch.dist.multihost_check --nproc 2 --device cuda  # ranks share a card
    python -m srcdsp_tpu_torch.dist.multihost_check --nproc 2 --device cuda --backend nccl

`--nproc` ranks, each a fresh process (``dist.launch``) holding `--shards`
time shards (4 by default) of a mesh of P = nproc * shards, joined by
``dist.init_multihost`` at a ``file://`` rendezvous. The backend is gloo
unless `--backend nccl` asks for one card a rank (NCCL refuses ranks that
share a card): gloo moves card tensors through the host and counts the
bytes (``dist.comm.STAGED``). On the card the parent builds the kernels once
before it starts the workers. Cases (`--cases`, default pipeline,k1):

- ``pipeline``: the reference's check: a pre-filter (lowpass(16, 0.45)) with
  its halo across ranks, the channelizer (M = 4P, 4 taps a phase) re-sharded
  by one all-to-all, the QPSK demod on each channel shard, the outputs
  gathered onto every rank;
- ``k1``: K1 (``dist.fused.mix_fir_time_sharded``) with its history across
  the process boundary;
- ``k11``: K11 (``dist.fused.fftconv_time_sharded``) the same way;
- ``k19``: K19 (``kernels.halo_dma.halo_from_left_pallas`` with the mesh)
  at K1's halo on [2, S] planes and at K11's overlap on 32 rows (config 3's
  16 channels): the boundary by CUDA IPC on one host (``dist.ipc``), by
  message across hosts and on the CPU; timed in turns with the message
  path, ``dist.halo.halo_from_left``;
- ``k20``: K20 (``kernels.halo_fused.mix_fir_halo_sharded``) at K1's shapes,
  its history and carried tail moving the same way; timed in turns with
  ``dist.fused.mix_fir_time_sharded`` (message halo plus concatenation);
- ``capture``: a ci16 capture file (seeded noise, written by rank 0) that
  every rank streams straight onto its shards (``io.capture.device_blocks``
  with ``time_sharding(mesh, 2)``: each rank decodes and copies only its own
  shards) through K20 over IPC (``mix_fir_halo_sharded``), the tail and the
  phase word carried from block to block (`stream_k20`); the outputs of all
  blocks gathered once;
- ``config5``: ``configs.build_config5``'s mesh form (64 channels);
- ``orbax``: each rank saves its shard states with
  ``checkpoint.save_orbax`` and restores a checkpoint one process wrote for
  the whole mesh (when the work directory holds one).

Rank 0 holds each gathered result against the port's one-process form on
its own device: the same mesh of P shards in one process (``torch.equal``),
one kernel call over the unsharded stream (K1, K11, K20: ``torch.equal``,
tails exact; K19: the slices of the unsharded stream; the capture: the
one-process stream of the same file), and the single-device form (indices equal; soft within 2e-5 for
config 5, its gate, and 1e-3 for the pipeline, the reference's). `--size small` runs the reference's shapes (out_tile 128,
b_rows 2), `--size full` the card's: config 1's 2^26 samples (the capture:
3 blocks of 2^26), config 3's 16 channels, config 5's 64 channels x 2^16
frames. Each worker reports its
step time (CUDA events on the card, the host clock on the CPU), the staged
bytes and its kernel launches in the distributed step (``kernels._build.
LAUNCHES``) on a ``SRCDSP_REPORT`` line; K19 and K20 report the step
without the gather too (`ms_bare`; its staged bytes and launches are the
ones reported) and their times in turns with the message path. Exit status
0 only if every case holds on every rank. The workers release the IPC
buffers (``dist.ipc.release``) before they leave the group.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

CASES = ("pipeline", "k1", "k11", "k19", "k20", "capture", "config5", "orbax")
SIZES = {
    # the reference's shapes (bench/multihost_check.py, tests/dist); K19's
    # (rows, columns a shard, halo) near tests/dist/test_halo_dma.py's, the
    # second at K11's overlap on 8 rows (the JAX interpreter's halo kernel,
    # which the CPU tests hold these to, stalls at 32 rows and halo 256 up)
    "small": dict(frames_per_shard=32, k1=(32, 0.2, 2, 0.31, 128, 2, 1),
                  k11=(64, 0.1, 2048, 2, 2, 1), c5_frames_per_shard=32,
                  k19=((2, 512, 128), (8, 2048, 1024)), capture=(3, 1)),
    # the card's: K1 (and K20) at config 1 (2^26 samples), K11 over config 3's
    # 16 channels (8 blocks a shard), config 5 at 64 channels x 2^16 frames,
    # K19's (rows, columns in all, halo): config 1's planes (halo: K1's hist)
    # and config 3's 32 rows of 8,355,840 samples (K11's overlap at 1024
    # taps), as phase 14 runs them
    "full": dict(frames_per_shard=1 << 14, k1=(64, 0.2, 2, 0.11, 512, 32, 1 << 26),
                 k11=(1024, 0.1, 4096, 16, 16, 8), c5_frames=1 << 16,
                 k19=((2, 1 << 26, 128), (32, 8_355_840, 1024)), capture=(3, 1 << 26)),
}
TURNS = 10                # timed turns of a kernel and its message-path yardstick
SOFT_GATE = 2e-5          # config 5's soft gate against the single-device build
# the pipeline's, as bench/multihost_check.py holds it: the composed stages sum
# in another order than fir_full + channelize_full over the whole stream
PIPELINE_SOFT_GATE = 1e-3
MASK32 = (1 << 32) - 1


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m srcdsp_tpu_torch.dist.multihost_check")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--shards", type=int, default=4, help="time shards a rank")
    ap.add_argument("--cases", default="pipeline,k1")
    ap.add_argument("--size", choices=tuple(SIZES), default="small")
    ap.add_argument("--work", default=None, help="work directory (default: a temporary one)")
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds for the whole run")
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    a.cases = tuple(c for c in a.cases.split(",") if c)
    bad = [c for c in a.cases if c not in CASES]
    if bad:
        ap.error(f"unknown cases {bad}; choose from {CASES}")
    return a


def rank_device(device: str, rank: int) -> torch.device:
    """Rank r's device: the CPU, or card r mod the card count."""
    from srcdsp_tpu_torch.device import resolve

    if device == "cpu":
        return torch.device("cpu")
    resolve("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


def one_process_mesh(p: int, dev: torch.device):
    """P time shards on `dev` in this process: the one-process form."""
    from srcdsp_tpu_torch.dist.mesh import Mesh

    return Mesh(tuple((dev,) for _ in range(p)))


def noise(seed: int, n: int) -> np.ndarray:
    """Seeded complex64 noise, the same on every rank."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def planes(seed: int, shape, dev: torch.device) -> torch.Tensor:
    """Seeded float32 planes made on `dev`, the same on every rank."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def shard_state(g: int, dev: torch.device) -> tuple:
    """Shard g's state in the orbax case: floats, a u32 word, complex."""
    return (torch.arange(16, dtype=torch.float32, device=dev) + 100.0 * g,
            torch.tensor((g * 2654435761) & MASK32, dtype=torch.int64, device=dev),
            torch.complex(torch.full((3,), g + 0.25, device=dev), torch.ones(3, device=dev)))


def _local_slice(x: torch.Tensor, spec, dim: int = -1) -> torch.Tensor:
    """This rank's contiguous part of x along `dim` (its shards' blocks)."""
    n = x.shape[dim] // spec.num_shards
    return x.narrow(dim, spec.indices[0] * n, len(spec.indices) * n)


def _timed(fn, dev: torch.device):
    """(ms, result) of one call: CUDA events on a card (the collectives' and
    signals' waits included), the host clock on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1), out
    t0 = time.perf_counter()
    out = fn()
    return (time.perf_counter() - t0) * 1e3, out


def _step(fn, dev: torch.device, bare=None):
    """{ms, launches, staged} and the result of one distributed step after a
    warm-up call; the kernel launches and the host-staged bytes
    (``dist.comm.STAGED``) are the timed call's alone. With `bare` (the step
    without its gather) that is timed first as `ms_bare`, and the launches
    and staged bytes reported are its own, with its IPC signal waits
    (``dist.ipc.SIGNALS``); `staged_gather` the full step's."""
    from srcdsp_tpu_torch.dist import comm, ipc
    from srcdsp_tpu_torch.kernels import _build

    res = {}
    if bare is not None:
        bare()
        _build.reset_launches()
        comm.reset_staged()
        ipc.reset_signals()
        res["ms_bare"], _ = _timed(bare, dev)
        res["launches"] = {k: v for k, v in _build.LAUNCHES.items() if v}
        res["staged"] = dict(comm.STAGED)
        res["signals"] = dict(ipc.SIGNALS)
    fn()
    _build.reset_launches()
    comm.reset_staged()
    res["ms"], out = _timed(fn, dev)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    if bare is None:
        res.update(launches=launches, staged=dict(comm.STAGED))
    else:
        res["staged_gather"] = dict(comm.STAGED)
    return res, out


def _turns(fns: dict, dev: torch.device) -> dict:
    """Median ms of each step over TURNS rounds in alternating order, with the
    bytes each staged and the median host ms it waited for IPC signals:
    {name: {"ms", "staged", "signal_ms"}}."""
    from srcdsp_tpu_torch.dist import comm, ipc

    times = {k: [] for k in fns}
    waits = {k: [] for k in fns}
    staged = {}
    for rnd in range(TURNS):
        for name in (fns if rnd % 2 == 0 else reversed(list(fns))):
            comm.reset_staged()
            ipc.reset_signals()
            ms, _ = _timed(fns[name], dev)
            times[name].append(ms)
            waits[name].append(ipc.SIGNALS["seconds"] * 1e3)
            staged[name] = comm.STAGED["bytes"]
    return {k: {"ms": float(np.median(v)), "staged": staged[k],
                "signal_ms": float(np.median(waits[k]))} for k, v in times.items()}


def _psk_demod(mesh, psks, bank):
    from srcdsp_tpu_torch.chains.psk import psk_apply, psk_init
    from srcdsp_tpu_torch.dist.mesh import map_shards

    return map_shards(lambda psk, b: psk_apply(psk, psk_init(psk, (b.shape[0],)), b)[1],
                      mesh, psks, bank)


def case_pipeline(a, mesh, dev, work: Path) -> dict:
    """pre-FIR -> channelizer (M = 4P) -> QPSK, gathered onto every rank."""
    from srcdsp_tpu_torch.chains.channelizer import channelize_full, design_prototype
    from srcdsp_tpu_torch.chains.psk import make_psk_params, psk_apply, psk_init
    from srcdsp_tpu_torch.dist.channelize import channelize_time_sharded
    from srcdsp_tpu_torch.dist.halo import fir_time_sharded
    from srcdsp_tpu_torch.dist.mesh import (
        TIME_AXIS, local_shards, per_device, process_allgather, shard, sharding, time_sharding)
    from srcdsp_tpu_torch.ops.fir import fir_full
    from srcdsp_tpu_torch.ops.window import lowpass

    p = mesh.shape[TIME_AXIS]
    m = 4 * p
    n = p * SIZES[a.size]["frames_per_shard"] * m
    proto = design_prototype(m, taps_per_phase=4)
    pre = torch.as_tensor(lowpass(16, 0.45), device=dev)
    x = torch.as_tensor(noise(0, n), device=dev)

    def psk_for(d):
        return make_psk_params(0.0, decim=1, sps=4, order=4, rrc_span=2, device=d)

    def step(shards, mesh):
        psks = per_device(psk_for, mesh.local_devices())
        y = fir_time_sharded(pre, shards, mesh)
        outs = _psk_demod(mesh, psks, channelize_time_sharded(proto, y, m, mesh))
        rows = sharding(mesh, TIME_AXIS, 0)
        return (process_allgather([o[0] for o in outs], rows),
                process_allgather([o[1] for o in outs], rows))

    spec = time_sharding(mesh)
    shards = local_shards(_local_slice(x, spec), mesh, spec)
    res, (idx, soft) = _step(lambda: step(shards, mesh), dev)
    res.update(channels=m, samples=n, ok=True)
    if mesh.rank == 0:
        mesh1 = one_process_mesh(p, dev)
        i1, s1 = step(shard(x, mesh1), mesh1)
        psk = psk_for(dev)
        ir, sr = psk_apply(psk, psk_init(psk, (m,)), channelize_full(proto, fir_full(pre, x), m))[1]
        dsoft = float((soft - sr).abs().max())
        res.update(equal_one_process=bool(torch.equal(idx, i1) and torch.equal(soft, s1)),
                   idx_equal_single=bool(torch.equal(idx, ir)), soft_max_diff_single=dsoft)
        res["ok"] = (res["equal_one_process"] and res["idx_equal_single"]
                     and dsoft <= PIPELINE_SOFT_GATE)
        np.savez(work / "pipeline.npz", x=x.cpu().numpy(), idx=idx.cpu().numpy(),
                 soft=soft.cpu().numpy(), channels=m)
    return res


def case_k1(a, mesh, dev, work: Path) -> dict:
    """K1 over this rank's time shards, the history across ranks."""
    from srcdsp_tpu_torch.dist.fused import mix_fir_time_sharded
    from srcdsp_tpu_torch.dist.mesh import (
        TIME_AXIS, local_shards, per_device, process_allgather, sharding, time_sharding)
    from srcdsp_tpu_torch.kernels.mixfir import make_mix_fir_kernel
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.window import lowpass

    ntaps, cutoff, decim, freq, ot, br, n = SIZES[a.size]["k1"]
    p = mesh.shape[TIME_AXIS]
    taps = lowpass(ntaps, cutoff)

    def kern(d):
        return make_mix_fir_kernel(taps, decim, out_tile=ot, b_rows=br, device=d)

    ks = per_device(kern, mesh.local_devices())
    n = n if n > 1 else p * ks[0].block_in()
    word = int(freq_to_word(freq))
    x = planes(1, (2, n), dev)
    spec = time_sharding(mesh, 2)
    shards = local_shards(_local_slice(x, spec), mesh, spec)
    tail0 = torch.zeros((2, ks[0].hist), device=dev)

    def step():
        tail, ys = mix_fir_time_sharded(ks, 0, word, tail0, shards, mesh)
        return tail, process_allgather(ys, sharding(mesh, TIME_AXIS, 1))

    res, (tail, y) = _step(step, dev)
    hist = ks[0].hist
    res.update(samples=n, ok=bool(torch.equal(tail, x[:, -hist:])))
    if mesh.rank == 0:
        yr, yi = ks[0].fn((-hist * word) & MASK32, word,
                          torch.cat([torch.zeros((2, hist), device=dev), x], dim=-1))
        res["equal_one_call"] = bool(torch.equal(y, torch.stack([yr.reshape(-1),
                                                                  yi.reshape(-1)])))
        res["ok"] = res["ok"] and res["equal_one_call"]
        if a.size == "small":
            np.savez(work / "k1.npz", x=x.cpu().numpy(), y=y.cpu().numpy(),
                     tail=tail.cpu().numpy(), word=word, taps=ntaps, cutoff=cutoff)
    return res


def case_k11(a, mesh, dev, work: Path) -> dict:
    """K11 over this rank's time shards of [C, 2, S], the overlap across ranks."""
    from srcdsp_tpu_torch.dist.fused import fftconv_time_sharded
    from srcdsp_tpu_torch.dist.mesh import (
        TIME_AXIS, local_shards, per_device, process_allgather, sharding, time_sharding)
    from srcdsp_tpu_torch.kernels.fftconv_pallas import fftconv_pallas, make_fftconv_kernel
    from srcdsp_tpu_torch.ops.window import lowpass

    ntaps, cutoff, fft, c, b_frames, blocks = SIZES[a.size]["k11"]
    p = mesh.shape[TIME_AXIS]
    taps = lowpass(ntaps, cutoff)
    ks = per_device(lambda d: make_fftconv_kernel(taps, fft, num_channels=c, b_frames=b_frames,
                                                  karatsuba=True, device=d),
                    mesh.local_devices())
    n = p * blocks * ks[0].block_in()
    x = planes(2, (c, 2, n), dev)
    spec = time_sharding(mesh, 3)
    shards = local_shards(_local_slice(x, spec), mesh, spec)
    ov = ks[0].overlap
    tail0 = torch.zeros((c, 2, ov), device=dev)

    def step():
        tail, yr, yi = fftconv_time_sharded(ks, tail0, shards, mesh)
        cols = sharding(mesh, TIME_AXIS, 1)
        return tail, process_allgather(yr, cols), process_allgather(yi, cols)

    res, (tail, yr, yi) = _step(step, dev)
    res.update(samples=c * n, ok=bool(torch.equal(tail, x[..., -ov:])))
    if mesh.rank == 0:
        r1, i1 = fftconv_pallas(ks[0], torch.cat([torch.zeros((c, 2, ov), device=dev), x], -1))
        res["equal_one_call"] = bool(torch.equal(yr, r1) and torch.equal(yi, i1))
        res["ok"] = res["ok"] and res["equal_one_call"]
    return res


def case_k19(a, mesh, dev, work: Path) -> dict:
    """K19 with the mesh on this rank's time shards, at each of its shapes."""
    from srcdsp_tpu_torch.dist.halo import halo_from_left
    from srcdsp_tpu_torch.dist.mesh import (
        TIME_AXIS, local_shards, process_allgather, shard, sharding, time_sharding)
    from srcdsp_tpu_torch.kernels.halo_dma import halo_from_left_pallas

    p = mesh.shape[TIME_AXIS]
    res = dict(ok=True, shapes=[])
    saved = {}
    for i, (rows, cols, halo) in enumerate(SIZES[a.size]["k19"]):
        n = cols if a.size == "full" else p * cols
        x = planes(19 + i, (rows, n), dev)
        spec = time_sharding(mesh, 2)
        shards = local_shards(_local_slice(x, spec), mesh, spec)
        stacked = sharding(mesh, TIME_AXIS, 0)

        def step(shards=shards, halo=halo, stacked=stacked):
            return process_allgather(halo_from_left_pallas(shards, halo, mesh), stacked,
                                     tiled=False)

        r, got = _step(step, dev, bare=lambda s=shards, h=halo: halo_from_left_pallas(s, h, mesh))
        r.update(rows=rows, samples=n, halo=halo, turns=_turns({
            "k19": lambda s=shards, h=halo: halo_from_left_pallas(s, h, mesh),
            "halo_from_left": lambda s=shards, h=halo: halo_from_left(s, h, mesh)}, dev))
        s_local = n // p
        want = torch.stack([torch.zeros((rows, halo), device=dev)]
                           + [x[:, q * s_local - halo:q * s_local] for q in range(1, p)])
        r["equal_slices"] = bool(torch.equal(got, want))
        r["ok"] = r["equal_slices"]
        if mesh.rank == 0:
            one = halo_from_left_pallas(shard(x, one_process_mesh(p, dev)), halo)
            r["equal_one_process"] = bool(torch.equal(got, torch.stack(one)))
            r["ok"] = r["ok"] and r["equal_one_process"]
            saved.update({f"x{i}": x.cpu().numpy(), f"got{i}": got.cpu().numpy(),
                          f"halo{i}": halo})
        res["ok"] = res["ok"] and r["ok"]
        res["shapes"].append(r)
        del x, shards, got, want
    # the first shape's step stands for the case in the report's common keys
    res.update({k: res["shapes"][0][k] for k in ("ms", "ms_bare", "launches", "staged")})
    if mesh.rank == 0 and a.size == "small":
        np.savez(work / "k19.npz", **saved)
    return res


def case_k20(a, mesh, dev, work: Path) -> dict:
    """K20 with the mesh on this rank's time shards, K1's shapes."""
    from srcdsp_tpu_torch.dist.fused import mix_fir_time_sharded
    from srcdsp_tpu_torch.dist.mesh import (
        TIME_AXIS, local_shards, per_device, process_allgather, shard, sharding, time_sharding)
    from srcdsp_tpu_torch.kernels.halo_fused import make_halo_fused_kernel, mix_fir_halo_sharded
    from srcdsp_tpu_torch.kernels.mixfir import make_mix_fir_kernel
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.window import lowpass

    ntaps, cutoff, decim, freq, ot, br, n = SIZES[a.size]["k1"]
    p = mesh.shape[TIME_AXIS]
    taps = lowpass(ntaps, cutoff)
    ks = per_device(lambda d: make_halo_fused_kernel(taps, decim, out_tile=ot, b_rows=br,
                                                     device=d), mesh.local_devices())
    k1s = per_device(lambda d: make_mix_fir_kernel(taps, decim, out_tile=ot, b_rows=br,
                                                   device=d), mesh.local_devices())
    n = n if n > 1 else p * k1s[0].block_in()
    word = int(freq_to_word(freq))
    x = planes(1, (2, n), dev)
    spec = time_sharding(mesh, 2)
    shards = local_shards(_local_slice(x, spec), mesh, spec)
    hist = ks[0].hist
    tail0 = torch.zeros((2, hist), device=dev)

    def bare():
        return mix_fir_halo_sharded(ks, 0, word, tail0, shards, mesh)

    def step():
        tail, ys = bare()
        return tail, process_allgather(ys, sharding(mesh, TIME_AXIS, 1))

    res, (tail, y) = _step(step, dev, bare=bare)
    res["turns"] = _turns({"k20": bare, "mix_fir_time_sharded": lambda: mix_fir_time_sharded(
        k1s, 0, word, tail0, shards, mesh)}, dev)
    res.update(samples=n, ok=bool(torch.equal(tail, x[:, -hist:])))
    if mesh.rank == 0:
        k1 = k1s[0]
        yr, yi = k1.fn((-hist * word) & MASK32, word,
                       torch.cat([torch.zeros((2, hist), device=dev), x], dim=-1))
        res["equal_one_call"] = bool(torch.equal(y, torch.stack([yr.reshape(-1),
                                                                  yi.reshape(-1)])))
        mesh1 = one_process_mesh(p, dev)
        t1, y1 = mix_fir_halo_sharded(ks[0], 0, word, tail0, shard(x, mesh1), mesh1)
        res["equal_one_process"] = bool(torch.equal(y, torch.cat(y1, dim=-1))
                                        and torch.equal(tail, t1))
        res["ok"] = res["ok"] and res["equal_one_call"] and res["equal_one_process"]
        if a.size == "small":
            np.savez(work / "k20.npz", x=x.cpu().numpy(), y=y.cpu().numpy(),
                     tail=tail.cpu().numpy(), word=word, taps=ntaps, cutoff=cutoff)
    return res


def write_noise_capture(path: Path, samples: int, seed: int, chunk: int = 1 << 24) -> None:
    """A ci16 capture of `samples` seeded int16 noise (+-8192, no sidecar: a
    full-scale ci16 file), written `chunk` samples at a time."""
    rng = np.random.default_rng(seed)
    with open(path, "wb") as f:
        for s0 in range(0, samples, chunk):
            n = min(chunk, samples - s0)
            rng.integers(-8192, 8192, 2 * n, dtype=np.int16).tofile(f)


def stream_k20(ks, word: int, path, block: int, mesh, start_block: int = 0):
    """K20 over a capture streamed straight onto the mesh's time shards
    (``io.capture.device_blocks`` with ``time_sharding(mesh, 2)``), block
    after block from rest, the tail and the phase carried: block b starts at
    word ``b*block*word`` mod 2^32 (`dist.fused.shard_word` with no history,
    exact integers). Returns (tail, [this rank's outputs of each block])."""
    from srcdsp_tpu_torch.dist.fused import shard_word
    from srcdsp_tpu_torch.dist.mesh import time_sharding
    from srcdsp_tpu_torch.io.capture import device_blocks
    from srcdsp_tpu_torch.kernels.halo_fused import mix_fir_halo_sharded

    spec = time_sharding(mesh, 2)
    hist = (ks[0] if isinstance(ks, (tuple, list)) else ks).hist
    tail = torch.zeros((2, hist), device=spec.local_devices[0])
    ys = []
    for b, shards in enumerate(device_blocks(str(path), block, start_block, planes=True,
                                             sharding=spec), start_block):
        tail, y = mix_fir_halo_sharded(ks, shard_word(0, word, b, block, 0), word, tail, shards,
                                       mesh)
        ys.append(y)
    return tail, ys


def case_capture(a, mesh, dev, work: Path) -> dict:
    """A capture file streamed onto this rank's shards through K20."""
    from srcdsp_tpu_torch.dist.mesh import TIME_AXIS, per_device, process_allgather, sharding
    from srcdsp_tpu_torch.io import capture
    from srcdsp_tpu_torch.kernels.halo_fused import make_halo_fused_kernel
    from srcdsp_tpu_torch.ops.nco import freq_to_word
    from srcdsp_tpu_torch.ops.window import lowpass

    ntaps, cutoff, decim, freq, ot, br, _ = SIZES[a.size]["k1"]
    blocks, block = SIZES[a.size]["capture"]
    p = mesh.shape[TIME_AXIS]
    taps = lowpass(ntaps, cutoff)
    ks = per_device(lambda d: make_halo_fused_kernel(taps, decim, out_tile=ot, b_rows=br,
                                                     device=d), mesh.local_devices())
    block = block if block > 1 else p * ks[0].block_in()
    word = int(freq_to_word(freq))
    path = work / "capture.ci16"
    if mesh.rank == 0:
        write_noise_capture(path, blocks * block, seed=23)
    torch.distributed.barrier()

    def bare():
        capture.reset_h2d()
        return stream_k20(ks, word, path, block, mesh)

    def step():
        tail, ys = bare()
        # one gather for the run: each shard's blocks stacked [blocks, 2, L]
        got = process_allgather([torch.stack(bs) for bs in zip(*ys)],
                                sharding(mesh, TIME_AXIS, 0), tiled=False)
        return tail, got.permute(1, 2, 0, 3).reshape(len(ys), 2, -1)

    res, (tail, y) = _step(step, dev, bare=bare)
    hist = ks[0].hist
    last = next(capture.read_capture_blocks(str(path), hist, blocks * block // hist - 1))
    want_tail = torch.as_tensor(np.stack([last.real, last.imag]), device=tail.device)
    k = len(mesh.local_devices())
    h2d = {d: dict(c) for d, c in capture.H2D.items()}
    res.update(samples=blocks * block, blocks=blocks, block=block, h2d=h2d,
               ok=bool(torch.equal(tail, want_tail))
               and sum(c["copies"] for c in h2d.values()) == blocks * k
               and sum(c["bytes"] for c in h2d.values()) == blocks * k * 8 * block // p)
    if mesh.rank == 0:
        t1, ys1 = stream_k20(ks[0], word, path, block, one_process_mesh(p, dev))
        y1 = torch.stack([torch.cat(yb, dim=-1) for yb in ys1])
        res["equal_one_process"] = bool(torch.equal(y, y1) and torch.equal(tail, t1))
        res["ok"] = res["ok"] and res["equal_one_process"]
        if a.size == "small":
            np.savez(work / "capture.npz", y=y.cpu().numpy(), tail=tail.cpu().numpy(),
                     word=word, taps=ntaps, cutoff=cutoff, block=block)
    return res


def case_config5(a, mesh, dev, work: Path) -> dict:
    """build_config5's mesh form across ranks against its one-process forms."""
    from srcdsp_tpu_torch.configs import build_config5
    from srcdsp_tpu_torch.dist.mesh import TIME_AXIS

    p = mesh.shape[TIME_AXIS]
    cfg = SIZES[a.size]
    frames = cfg.get("c5_frames") or p * cfg["c5_frames_per_shard"]
    b = build_config5(frames, 64, mesh=mesh)
    res, (idx, soft) = _step(lambda: b.step(*b.example), dev)
    res.update(frames=frames, ok=True)
    if mesh.rank == 0:
        bm = build_config5(frames, 64, mesh=one_process_mesh(p, dev))
        im, sm = bm.step(*bm.example)
        b1 = build_config5(frames, 64, device=dev)
        i1, s1 = b1.step(*b1.example)
        dsoft = float((soft - s1).abs().max())
        res.update(equal_one_process=bool(torch.equal(idx, im) and torch.equal(soft, sm)),
                   idx_equal_single=bool(torch.equal(idx, i1)), soft_max_diff_single=dsoft)
        res["ok"] = res["equal_one_process"] and res["idx_equal_single"] and dsoft <= SOFT_GATE
        torch.save({"idx": idx.cpu(), "soft": soft.cpu()}, work / "config5.pt")
    return res


def case_orbax(a, mesh, dev, work: Path) -> dict:
    """save_orbax of this rank's shard states; restore of a one-process save."""
    from srcdsp_tpu_torch import checkpoint
    from srcdsp_tpu_torch.dist.mesh import time_sharding

    spec = time_sharding(mesh)
    mine = tuple(shard_state(g, dev) for g in spec.indices)
    res, _ = _step(lambda: checkpoint.save_orbax(str(work / "orbax_ranks"), mine, 5,
                                                 sharding=spec), dev)
    res.update(ok=True, restored=False)
    if (work / "orbax_one.dcp").exists():
        ex = tuple(tuple(torch.zeros_like(t) for t in st) for st in mine)
        got, blk = checkpoint.restore_orbax(str(work / "orbax_one"), ex, sharding=spec)
        res["restored"] = True
        res["ok"] = blk == 9 and all(torch.equal(u, v) for st, ref in zip(got, mine)
                                     for u, v in zip(st, ref))
    return res


def worker(a) -> int:
    from srcdsp_tpu_torch.dist import ipc
    from srcdsp_tpu_torch.dist.launch import report
    from srcdsp_tpu_torch.dist.mesh import init_multihost, make_mesh

    torch.set_num_threads(1)
    rank = a.worker
    dev = rank_device(a.device, rank)
    init_multihost(a.init, a.nproc, rank, a.backend,
                   device=dev if a.backend == "nccl" else None, timeout=a.timeout)
    try:
        mesh = make_mesh(time=a.nproc * a.shards, devices=[dev] * a.shards)
        work = Path(a.work)
        cases = {name: globals()[f"case_{name}"](a, mesh, dev, work) for name in a.cases}
        report(rank=rank, backend=a.backend, device=str(dev), shards=a.shards,
               mesh=mesh.shape, cases=cases)
        ipc.release()
        torch.distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()
    return 0 if all(c["ok"] for c in cases.values()) else 1


def start(nproc: int = 2, device: str = "cpu", backend: str = "gloo", shards: int = 4,
          cases=("pipeline", "k1"), size: str = "small", work=None, timeout: float = 600.0):
    """Start the workers (``dist.launch.Run``); the kernels are built here
    first when the run is on the card. `collect` waits for them."""
    from srcdsp_tpu_torch.dist import launch

    if device == "cuda" and any(c in cases for c in ("k1", "k11", "k19", "k20", "capture")):
        from srcdsp_tpu_torch.kernels import _build

        rank_device(device, 0)
        _build.build()
    work = Path(work)
    argv = ["--nproc", str(nproc), "--device", device, "--backend", backend, "--shards",
            str(shards), "--cases", ",".join(cases), "--size", size, "--work", str(work),
            "--timeout", str(timeout)]
    run = launch.start("srcdsp_tpu_torch.dist.multihost_check", nproc, argv, work, timeout,
                       tag=f"check{nproc}")
    return run


def collect(run) -> dict:
    """Wait for a started run and gather its reports: {"ok", "codes",
    "reports" (one per rank), "seconds", "work", "error"}."""
    from srcdsp_tpu_torch.dist import launch

    codes, texts = launch.finish(run)
    reps = [launch.reports(t) for t in texts]
    ok = all(c == 0 for c in codes) and all(len(x) == 1 for x in reps)
    return dict(ok=ok, codes=codes, reports=[x[0] if x else None for x in reps],
                seconds=time.perf_counter() - run.t0, work=run.work,
                error=None if ok else launch.failure(codes, texts, "multihost_check"))


def run(*args, **kwargs) -> dict:
    """`start` then `collect`."""
    return collect(start(*args, **kwargs))


def summary(res: dict) -> str:
    """One line a case and rank: ok, step ms, staged bytes, launches."""
    lines = []
    for rep in res["reports"]:
        if rep is None:
            continue
        for name, c in rep["cases"].items():
            extra = {k: v for k, v in c.items() if k not in ("ms", "ok", "launches", "staged")}
            lines.append(f"rank {rep['rank']} {name}: ok {c['ok']}, step {c['ms']:.3f} ms, "
                         f"staged {c['staged']['bytes']} B in {c['staged']['copies']} copies "
                         f"({c['staged']['seconds'] * 1e3:.3f} ms), launches "
                         f"{c.get('launches', {})} {extra}")
    return "\n".join(lines)


def main(argv=None) -> int:
    a = parse(argv)
    if a.worker is not None:
        return worker(a)
    with tempfile.TemporaryDirectory() as tmp:
        res = run(a.nproc, a.device, a.backend, a.shards, a.cases, a.size, a.work or tmp,
                  a.timeout)
    print(summary(res))
    if not res["ok"]:
        print(res["error"], file=sys.stderr)
        return 1
    print(f"multihost check: {a.nproc} processes x {a.shards} shards ({a.backend}, "
          f"{a.device}), {','.join(a.cases)} equal to the one-process run across the process "
          f"boundary, {res['seconds']:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
