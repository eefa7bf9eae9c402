#!/usr/bin/env python3
"""K10 / K11 at the sizes whose four-step lines became Bluestein lines, timed
with any tree's own code, and the register bodies' output hashes, to hold two
trees against each other on one card. Run from the root of the tree to
measure (its package and its ``chip_smoke.py`` are the ones imported):

    cd <tree> && PYTHONPATH=. python <this repo>/bench_torch/ab_fft_lines.py times
    cd <tree> && PYTHONPATH=. python <this repo>/bench_torch/ab_fft_lines.py bits
    PYTHONPATH=. python bench_torch/ab_fft_lines.py ptxas

``times``: K10 at 1024 x 1021 and 884,736 in turns with cuFFT (one call, 5
back to back, as ``chip_smoke.py`` phase 23 times them) and its median of 5;
K11 a chunk at 17408 and 1024 x 1021 (median of 5, as phase 23's rows).
``bits``: sha256 of K10's natural and digit stores and of K11's output on
seeded inputs at sizes whose lines are all register lines (and the one-block
and power-of-two bodies); equal hashes on two trees mean equal bits.
``ptxas`` (this tree, compile only): each Bluestein kernel's registers and
spill bytes in two text substitutions of ``csrc/fft_4step.cu`` compiled
together under ``build/``: 1024 threads a block (64 registers), and that
with the Bluestein table loops unrolled by 4 (``VARIANTS``; a stale pattern
stops the script). Each prints one JSON line. Needs the card (``ptxas``
only nvcc).
"""

import hashlib
import json
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, ".")
import chip_smoke as c  # noqa: E402  (the tree's own, from the working directory)
from srcdsp_tpu_torch.configs import C3_CUTOFF, seeded_planes  # noqa: E402
from srcdsp_tpu_torch.kernels import _build, fft_pallas as kfft, fftconv_pallas as kfc  # noqa: E402
from srcdsp_tpu_torch.ops.window import lowpass  # noqa: E402


def times(dev) -> dict:
    out = {"card": c.card_line()}
    for n in (1024 * 1021, 27 << 15):
        frames = c.C23_SAMPLES // n // c.C23_BFRAMES * c.C23_BFRAMES
        g = torch.Generator(device=dev).manual_seed(n)
        xr = torch.randn((frames, n), device=dev, generator=g)
        xi = torch.randn((frames, n), device=dev, generator=g)
        xc = torch.complex(xr, xi)
        k = kfft.make_fft_kernel(n, n2=128, b_frames=c.C23_BFRAMES, device=dev)
        fns = {"kernel": lambda: k.fn(xr, xi), "cuFFT": lambda: torch.fft.fft(xc, dim=-1)}
        t1 = {a: float(np.median(v)) for a, v in c.in_turns(torch, fns, 2 * c.REPS).items()}
        t5 = {a: float(np.median(v)) for a, v in c.in_turns(torch, fns, 2 * c.REPS,
                                                             calls=c.REPS).items()}
        ms = c.median_ms(torch, lambda: k.fn(xr, xi))
        out[f"K10_{n}"] = dict(one=t1["kernel"], b2b=t5["kernel"], cufft_one=t1["cuFFT"],
                               ratio=t1["kernel"] / t1["cuFFT"], median=ms, frames=frames,
                               lines=str(kfft.fft_plan(n).lines))
        del xr, xi, xc, k
    for fft, ntaps, blocks in ((c.C23_4STEP_FFT, c.C23_4STEP_TAPS, c.C23_4STEP_BLOCKS),
                               (c.C23_PRIME_FFT, c.C23_PRIME_TAPS, c.C23_PRIME_BLOCKS)):
        kc = kfc.make_fftconv_kernel(lowpass(ntaps, C3_CUTOFF), fft,
                                     num_channels=c.C3_CHANNELS, b_frames=c.C23_BFRAMES_K11,
                                     device=dev)
        chunk = blocks // 5 * kc.block_in()
        xk = seeded_planes(c.C3_CHANNELS, kc.overlap, chunk, seed=23, device=dev)
        out[f"K11_{fft}"] = c.median_ms(torch, lambda: kfc.fftconv_pallas(kc, xk))
        del xk, kc
    return out


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def bits(dev) -> dict:
    out = {}
    for n, n2 in ((4096, 128), (8192, 128), (3072, 384), (11264, 128), (16384, 128),
                  (21504, 128), (65536, 128), (1 << 20, 1024), (3 << 15, 128)):
        b = max(16, (1 << 23) // n)
        g = torch.Generator(device=dev).manual_seed(n)
        xr, xi = (torch.randn((b, n), device=dev, generator=g) for _ in range(2))
        for order in (True, False):
            k = kfft.make_fft_kernel(n, n2=n2, b_frames=1, natural_order=order, device=dev)
            out[f"K10_{n}_{order}"] = digest(*k.fn(xr, xi))
    for fft, taps in ((4096, 1024), (12288, 3000), (16384, 4096), (21504, 5376)):
        k = kfc.make_fftconv_kernel(lowpass(taps, 0.1), fft, num_channels=4, b_frames=2,
                                    device=dev)
        x = torch.as_tensor(np.random.default_rng(fft).standard_normal(
            (4, 2, k.overlap + 8 * k.block_in())).astype(np.float32), device=dev)
        out[f"K11_{fft}"] = digest(*kfc.fftconv_pallas(k, x))
    return out


def _unroll4(text: str, start: str, end: str | None = None) -> str:
    """`#pragma unroll` -> `#pragma unroll 4` from `start` (to `end`)."""
    a = text.index(start)
    b = text.index(end) if end else len(text)
    return text[:a] + text[a:b].replace("#pragma unroll\n", "#pragma unroll 4\n") + text[b:]


def _threads_1024(text: str) -> str:
    old = "constexpr int kBluesteinThreads = 512;"
    if old not in text:
        raise SystemExit(f"stale pattern: {old}")
    return text.replace(old, "constexpr int kBluesteinThreads = 1024;")


# name: (fft_lines.cuh edit, fft_4step.cu edit)
VARIANTS = {
    "threads1024": (lambda t: t, _threads_1024),
    "threads1024_unroll4": (
        lambda t: _unroll4(t, "struct BluesteinShape"),
        lambda t: _unroll4(_threads_1024(t), "// Step 1 on Bluestein lines", "// --- the host side")),
}


def ptxas() -> dict:
    root = _build.BUILD_ROOT / "ab_fft_lines"
    procs = {}
    for name, (edit_lines, edit_4step) in VARIANTS.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for h in _build.HEADERS:
            shutil.copy(_build.CSRC / h, d / h)
        (d / "fft_lines.cuh").write_text(edit_lines((_build.CSRC / "fft_lines.cuh").read_text()))
        (d / "fft_4step.cu").write_text(edit_4step((_build.CSRC / "fft_4step.cu").read_text()))
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(d / "v.o"), str(d / "fft_4step.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        rep = _build.ptxas_report(log)
        out[name] = {}
        for k, v in rep.items():
            m = re.search(r"(fft4_\w+?_bluestein|fftconv4_\w+?_bluestein)ILi(\d+)E", k)
            if m:
                out[name][f"{m.group(1)}<{m.group(2)}>"] = v
    return out


def main() -> None:
    mode = sys.argv[1] if len(sys.argv) > 1 else "times"
    if mode not in ("times", "bits", "ptxas"):
        raise SystemExit("usage: ab_fft_lines.py times|bits|ptxas")
    if mode == "ptxas":
        print("PTXAS " + json.dumps(ptxas()), flush=True)
        return
    if not torch.cuda.is_available():
        raise SystemExit("ab_fft_lines.py needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.time()
    _build.load()
    print(f"build {time.time() - t:.1f} s", flush=True)
    dev = torch.device("cuda", 0)
    print(mode.upper() + " " + json.dumps(times(dev) if mode == "times" else bits(dev)),
          flush=True)


if __name__ == "__main__":
    main()
