#!/usr/bin/env python3
"""A/B of the overlap-save kernel K11 (srcdsp_tpu_torch/csrc/fftconv.cu)
against variants of itself and the batched FFT K10, on one card.

    PYTHONPATH=. python bench_torch/ab_fftconv.py [--turns 10]

Builds, from the checkout's sources, one library per variant into
build/ab_fftconv/<variant>/ (nvcc with the port's flags, all started
together):

- ``kernel``: fftconv.cu as it is (2 blocks per SM of 256 threads, up to
  128 registers);
- ``occ4``: 4 blocks per SM, K10's 64-register cap;
- ``occ3``: 3 blocks per SM, up to 80 registers;
- ``fence8``, ``fence4``: a compiler fence after every 8 or 4 registers of
  the product with H, so that H's loads are not all hoisted together.

Each variant's output must equal the kernel's bit for bit (the same
arithmetic). Then times each on one config-3 chunk (16 channels x 1,671,168
samples, 1024 taps, fft 4096, hop 3072: 8704 frames), beside K10 (natural
order, csrc/fft.cu) on 8704 frames of 4096, one transform's worth, in turns
(forward, then backward), each turn 5 launches back to back between CUDA
events. Prints the card's name and power limit first, then each variant's
registers and spills as ptxas reports them.
"""

from __future__ import annotations

import argparse
import ctypes
import re
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
from srcdsp_tpu_torch.kernels import fftconv_pallas as kfc  # noqa: E402
from srcdsp_tpu_torch.ops.window import lowpass  # noqa: E402

BLOCKS = re.compile(r"kFftconvMinBlocks =\s*[^;]*;")
NEGATE = "vi[s] = -vi[s];"
SUBS = {f"occ{n}": (BLOCKS, f"kFftconvMinBlocks = FftRegsShape<LOG2N>::kThreads >= 512 ? "
                            f"{max(1, n // 2)} : {256 * n} / FftRegsShape<LOG2N>::kThreads;")
        for n in (4, 3)}
C, CHUNK, N = 16, 34 * 49152, 4096


def build() -> dict[str, ctypes.CDLL]:
    csrc = REPO / "srcdsp_tpu_torch" / "csrc"
    cu = (csrc / "fftconv.cu").read_text()
    if not BLOCKS.search(cu) or NEGATE not in cu:
        raise SystemExit("ab_fftconv: the source has changed; update the variants")
    sources = {"kernel": cu, **{k: old.sub(new, cu) for k, (old, new) in SUBS.items()},
               **{f"fence{n}": cu.replace(NEGATE, NEGATE + f' if (s % {n} == {n - 1}) '
                                          'asm volatile("" ::: "memory");') for n in (8, 4)}}
    root = REPO / "build" / "ab_fftconv"
    procs = {}
    for name, text in sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "fftconv.cu").write_text(text)
        for h in ("fsk_common.cuh", "fft_regs.cuh"):
            shutil.copy(csrc / h, d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "fftconv.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ab_fftconv: nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if re.search(r"Compiling entry function '\w*fftconv_kernelILi12E", ln):
                used = next(x.strip() for x in lines[i:] if "Used" in x)
                spill = next(x.strip() for x in lines[i:] if "spill" in x)
                print(f"{name}: N = 4096: {used}; {spill}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.srcdsp_fftconv.argtypes = _build._SIGNATURES["srcdsp_fftconv"]
        libs[name] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_fftconv: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build()
    dev = torch.device("cuda", 0)
    k = kfc.make_fftconv_kernel(lowpass(1024, 0.1), N, num_channels=C, b_frames=16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((C, 2, k.overlap + CHUNK), device=dev, generator=gen)
    h2 = torch.as_tensor(kfc.freq_response_planes(lowpass(1024, 0.1), N), device=dev)
    tw = torch.as_tensor(kfft.stockham_twiddles(N), device=dev)
    frames = C * CHUNK // k.hop
    yr = torch.empty((C, CHUNK), device=dev)
    yi = torch.empty_like(yr)

    def launch(name):
        rc = libs[name].srcdsp_fftconv(x.data_ptr(), h2.data_ptr(), tw.data_ptr(), yr.data_ptr(),
                                       yi.data_ptr(), C, x.shape[-1], CHUNK // k.hop, k.hop, 12,
                                       0, _build.stream_handle(x))
        if rc:
            raise SystemExit(f"ab_fftconv: {name} failed with cudaError_t {rc}")

    launch("kernel")
    ref = (yr.clone(), yi.clone())
    fns = {}
    for name in libs:
        launch(name)
        if not (torch.equal(yr, ref[0]) and torch.equal(yi, ref[1])):
            raise SystemExit(f"ab_fftconv: {name} differs from the kernel")
        fns[name] = lambda name=name: launch(name)
    fk = kfft.make_fft_kernel(N, b_frames=1, natural_order="kernel", device=dev)
    fr = torch.randn((frames, N), device=dev, generator=gen)
    fi = torch.randn((frames, N), device=dev, generator=gen)
    fns[f"K10 natural, {frames} frames"] = lambda: fk.fn(fr, fi)
    times = {n: [] for n in fns}
    for fn in fns.values():
        fn()
    for rnd in range(args.turns):
        for n in (list(fns) if rnd % 2 == 0 else list(reversed(list(fns)))):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(5):
                fns[n]()
            e1.record()
            e1.synchronize()
            times[n].append(e0.elapsed_time(e1) / 5)
    bound = (x.numel() + 2 * yr.numel()) * 4 / 3.35e12 * 1e3
    print(f"{C} x {CHUNK} samples, {frames} frames of {N}, {args.turns} turns of 5 launches back "
          f"to back; every variant == the kernel (torch.equal); K11 bound {bound:.4f} ms")
    for n, v in times.items():
        m = float(np.median(v))
        print(f"{n:32s} median {m:.4f} ms (min {min(v):.4f}, max {max(v):.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
