#!/usr/bin/env python3
"""A/B of the batched FFT kernel K10 (srcdsp_tpu_torch/csrc/fft.cu) against
variants of itself and cuFFT, on one card.

    PYTHONPATH=. python bench_torch/ab_fft.py [--batch 8192] [--turns 20]

Builds, from the checkout's sources, one library per variant into
build/ab_fft/<variant>/ (nvcc with the port's flags, all started together):

- ``kernel``: fft.cu as it is;
- ``copy``: the same loads and stores with the transform left out, so the
  same access pattern with no arithmetic and no shared memory: the floor of
  this design's time;
- ``streaming``: loads and stores with the evict-first hints (__ldcs,
  __stcs);
- ``occ3``: 3 blocks per SM at N = 4096 instead of 4 (up to 80 registers).

Then times each on 8192 frames of 4096 points (natural order, and the
kernel's digit order) beside torch.fft.fft on the same frames, in turns
(forward, then backward), each turn 5 launches back to back between CUDA
events (the card's time, no host path), and prints the medians, each
variant's output checked equal to the kernel's (but ``copy``'s). Prints the
card's name and power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from srcdsp_tpu_torch.kernels import _build  # noqa: E402
from srcdsp_tpu_torch.kernels import fft_pallas as kfft  # noqa: E402

N, LOG2N, LOG2N2 = 4096, 12, 7
# (old, new) source lines of the streaming variant: evict-first loads and stores
STREAMING = (("vr[s] = live ? xr[off + t + T * s] : 0.f;",
              "vr[s] = live ? __ldcs(xr + off + t + T * s) : 0.f;"),
             ("vi[s] = live ? xi[off + t + T * s] : 0.f;",
              "vi[s] = live ? __ldcs(xi + off + t + T * s) : 0.f;"),
             ("yr[off + t + T * s] = vr[s];", "__stcs(yr + off + t + T * s, vr[s]);"),
             ("yi[off + t + T * s] = vi[s];", "__stcs(yi + off + t + T * s, vi[s]);"))


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"ab_fft: {old!r} not in the source; update the variant")
    return text.replace(old, new)


def variants() -> dict[str, tuple[str, str]]:
    csrc = REPO / "srcdsp_tpu_torch" / "csrc"
    cu, h = (csrc / "fft.cu").read_text(), (csrc / "fft_regs.cuh").read_text()
    stream = cu
    for old, new in STREAMING:
        stream = _sub(stream, old, new)
    return {
        "kernel": (cu, h),
        "copy": (_sub(cu, "fft_regs_forward<LOG2N>(vr, vi, t, sr, si, tw);", ""), h),
        "streaming": (stream, h),
        "occ3": (cu, _sub(h, "kMinBlocks = 1024 / kThreads;", "kMinBlocks = 768 / kThreads;")),
    }


def build(names_sources: dict) -> dict[str, ctypes.CDLL]:
    root = REPO / "build" / "ab_fft"
    procs = {}
    for name, (cu, h) in names_sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fft.cu").write_text(cu)
        (d / "fft_regs.cuh").write_text(h)
        shutil.copy(REPO / "srcdsp_tpu_torch" / "csrc" / "fsk_common.cuh", d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "fft.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ab_fft: nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        at = next(i for i, ln in enumerate(lines) if "Compiling entry" in ln and "ILi12E" in ln)
        used = next(ln.strip() for ln in lines[at:] if "Used" in ln)
        print(f"{name}: N = 4096 kernel: {used}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.srcdsp_fft.argtypes = _build._SIGNATURES["srcdsp_fft"]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--turns", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_fft: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(variants())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = args.batch
    xr = torch.randn((b, N), device=dev, generator=gen)
    xi = torch.randn((b, N), device=dev, generator=gen)
    xc = torch.complex(xr, xi)
    tw = torch.as_tensor(kfft.stockham_twiddles(N), device=dev)
    yr, yi = torch.empty_like(xr), torch.empty_like(xi)

    def launch(name: str, natural: int):
        rc = libs[name].srcdsp_fft(xr.data_ptr(), xi.data_ptr(), tw.data_ptr(), yr.data_ptr(),
                                   yi.data_ptr(), b, LOG2N, LOG2N2, natural,
                                   _build.stream_handle(xr))
        if rc:
            raise SystemExit(f"ab_fft: {name} launch failed with cudaError_t {rc}")

    fns = {}
    for natural, order in ((1, "natural"), (0, "digit")):
        launch("kernel", natural)
        ref = (yr.clone(), yi.clone())
        for name in libs:
            launch(name, natural)
            if name != "copy" and not (torch.equal(yr, ref[0]) and torch.equal(yi, ref[1])):
                raise SystemExit(f"ab_fft: {name} ({order}) differs from the kernel")
            fns[f"{name} {order}"] = lambda name=name, natural=natural: launch(name, natural)
    fns["cuFFT"] = lambda: torch.fft.fft(xc, dim=-1)
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for rnd in range(args.turns):
        for k in (list(fns) if rnd % 2 == 0 else list(reversed(list(fns)))):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(5):
                fns[k]()
            e1.record()
            e1.synchronize()
            times[k].append(e0.elapsed_time(e1) / 5)
    bound = 4 * b * N * 4 / 3.35e12 * 1e3
    cufft = float(np.median(times["cuFFT"]))
    print(f"{b} x {N}, {args.turns} turns of 5 launches back to back; bound {bound:.4f} ms")
    for k, v in times.items():
        m = float(np.median(v))
        print(f"{k:20s} median {m:.4f} ms (min {min(v):.4f}, max {max(v):.4f}); "
              f"{m / cufft:.3f} x cuFFT, {bound / m:.3f} of the bound")
    return 0


if __name__ == "__main__":
    sys.exit(main())
