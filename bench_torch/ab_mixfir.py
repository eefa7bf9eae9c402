#!/usr/bin/env python3
"""A/B of the mix + FIR + decimate kernel K1 (srcdsp_tpu_torch/csrc/mixfir.cu)
against variants of itself and the row-form kernel K18, on one card.

    PYTHONPATH=. python bench_torch/ab_mixfir.py [--turns 10]

Builds, from the checkout's sources, one library per variant into
build/ab_mixfir/<variant>/ (nvcc with the port's flags, all started
together):

- ``kernel``: mixfir.cu as it is;
- ``t256``: blocks of 256 threads at every decim;
- ``t64``: blocks of 64 threads at decim 1 and 2;
- ``d4t128``: blocks of 128 threads at decim 4;
- ``r4``: 4 outputs a thread at decim 1 and 2 instead of 8;
- ``b4``, ``b16``: 4 or 16 window samples loaded a thread before it mixes
  any, instead of 8;

and three ablations, which compute something else and are only timed:
``nomix`` (no phasor: each sample times 1), ``nofir`` (the window staged,
no FIR) and ``nostage`` (zeros written to the window, no loads, no mix).

Every variant but the ablations sums each output in the same order, so its
output must equal the kernel's bit for bit. Then times each at three shapes,
in turns (forward, then backward), each turn 5 launches back to back between
CUDA events: config 1 (2^26 samples, 64 taps, decim 2, out_tile 512), one
config-4 chunk (32 x 2^22, 64 taps, decim 4) and decim 1 at 128 taps (2^25
samples, config 2's first stage), beside K18 (csrc/rows.cu, unchanged) at
config 1 as the same-run yardstick. Last, at config 1, the kernel one launch
per turn, directly and through the port's wrapper (make_mix_fir_kernel(...).fn,
words by value, outputs allocated per call): the host path a single call
adds. Prints the card's name and power limit first, then each variant's
registers and spills as ptxas reports them.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from srcdsp_tpu_torch.kernels import _build  # noqa: E402
from srcdsp_tpu_torch.kernels import mixfir as kmf  # noqa: E402
from srcdsp_tpu_torch.kernels import mixfir_rows as krw  # noqa: E402
from srcdsp_tpu_torch.ops.nco import freq_to_word  # noqa: E402
from srcdsp_tpu_torch.ops.window import lowpass  # noqa: E402

THREADS = "kThreads = D == 4 ? 256 : 128;"
RING = "kR = D == 4 ? 4 : (D == 1 || D == 2) ? 8 : 1;"
FIR = "fir_outputs<D>(sh, sr, si, base, g.tp, ar, ai);"
BATCH = "kStageBatch = 8;"
STAGE = re.compile(r"stage_window<true, Src, PaddedIndex, kStageBatch>\([^;]*;")
ZEROS = ("for (int i = threadIdx.x; i < g.span; i += blockDim.x) "
         "sr[fir_pad(i, S::kLog2Stride)] = si[fir_pad(i, S::kLog2Stride)] = 0.f;")
PHASOR = "phasor(w0 + (uint32_t)(base + i) * dw, &cs, &sn);"
# variant: ([(old, new) in mixfir.cu], [(old, new) in fsk_common.cuh])
SUBS = {
    "t256": ([(THREADS, "kThreads = 256;")], []),
    "t64": ([(THREADS, "kThreads = D == 4 ? 256 : 64;")], []),
    "d4t128": ([(THREADS, "kThreads = 128;")], []),
    "r4": ([(RING, "kR = D == 4 || D == 2 || D == 1 ? 4 : 1;")], []),
    "b4": ([(BATCH, "kStageBatch = 4;")], []),
    "b16": ([(BATCH, "kStageBatch = 16;")], []),
    "nomix": ([], [(PHASOR, "cs = 1.f; sn = 0.f;")]),
    "nofir": ([(FIR, "ar[0] = sr[base]; ai[0] = si[base];")], []),
    "nostage": ([(STAGE, ZEROS)], []),
}
# (label, channels, samples per channel, taps, decim)
SHAPES = (("config 1", 1, 1 << 26, 64, 2), ("config 4 chunk", 32, 1 << 22, 64, 4),
          ("decim 1, 128 taps", 1, 1 << 25, 128, 1))
OUT_TILE = 512


def _sub(text: str, old, new: str) -> str:
    if isinstance(old, re.Pattern):
        if not old.search(text):
            raise SystemExit(f"ab_mixfir: {old.pattern!r} not in the source; update the variant")
        return old.sub(lambda _: new, text)
    if old not in text:
        raise SystemExit(f"ab_mixfir: {old!r} not in the source; update the variant")
    return text.replace(old, new)


def variants() -> dict[str, tuple[str, str]]:
    csrc = REPO / "srcdsp_tpu_torch" / "csrc"
    cu, h = (csrc / "mixfir.cu").read_text(), (csrc / "fsk_common.cuh").read_text()
    out = {"kernel": (cu, h)}
    for name, (cu_subs, h_subs) in SUBS.items():
        c, hh = cu, h
        for old, new in cu_subs:
            c = _sub(c, old, new)
        for old, new in h_subs:
            hh = _sub(hh, old, new)
        out[name] = (c, hh)
    return out


def build(sources: dict[str, tuple[str, str]]) -> dict[str, ctypes.CDLL]:
    root = REPO / "build" / "ab_mixfir"
    procs = {}
    for name, (cu, h) in sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "mixfir.cu").write_text(cu)
        (d / "fsk_common.cuh").write_text(h)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
             str(d / "mixfir.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ab_mixfir: nvcc failed on {name}:\n{log}")
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            m = re.search(r"Compiling entry function '(_Z\w*(mixfir)_kernelILi([124])E\w*)'", ln)
            if m:
                used = next(x.strip() for x in lines[i:] if "Used" in x)
                spill = next(x.strip() for x in lines[i:] if "spill" in x)
                print(f"{name}: {m.group(2)} D={m.group(3)}: {used}; {spill}")
        lib = ctypes.CDLL(str(root / name / "lib.so"))
        lib.srcdsp_mixfir.argtypes = _build._SIGNATURES["srcdsp_mixfir"]
        libs[name] = lib
    return libs


def turns(fns: dict, count: int, calls: int) -> dict:
    """Times in ms of each fn per call over `count` turns in alternating
    order, each turn `calls` calls back to back between CUDA events."""
    times = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for rnd in range(count):
        for k in (list(fns) if rnd % 2 == 0 else list(reversed(list(fns)))):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(calls):
                fns[k]()
            e1.record()
            e1.synchronize()
            times[k].append(e0.elapsed_time(e1) / calls)
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_mixfir: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(variants())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    word = int(freq_to_word(0.11))
    fns, shape_of, bounds = {}, {}, {}
    for label, c, n, t, decim in SHAPES:
        hist = 128
        x = torch.randn((c, 2, hist + n), device=dev, generator=gen)
        taps = torch.as_tensor(lowpass(t, 0.4 / decim), device=dev)
        nt = n // (OUT_TILE * decim)
        yr = torch.empty((c, nt, OUT_TILE), device=dev)
        yi = torch.empty_like(yr)
        w0 = np.full(c, (-hist * word) % (1 << 32), np.uint32)
        dw = np.full(c, word, np.uint32)
        bounds[label] = (x.numel() + 2 * yr.numel()) * 4 / 3.35e12 * 1e3

        def launch(name, x=x, taps=taps, yr=yr, yi=yi, w0=w0, dw=dw, c=c, nt=nt, t=t,
                   decim=decim, label=label):
            rc = libs[name].srcdsp_mixfir(x.data_ptr(), taps.data_ptr(), 0, yr.data_ptr(),
                                          yi.data_ptr(), w0.ctypes.data, dw.ctypes.data, c,
                                          x.shape[-1], nt, OUT_TILE, decim, t, hist,
                                          _build.stream_handle(x))
            if rc:
                raise SystemExit(f"ab_mixfir: {name} at {label} failed with cudaError_t {rc}")

        launch("kernel")
        ref = (yr.clone(), yi.clone())
        for name in libs:
            launch(name)
            if name[:2] != "no" and not (torch.equal(yr, ref[0]) and torch.equal(yi, ref[1])):
                raise SystemExit(f"ab_mixfir: {name} at {label} differs from the kernel")
            fns[f"{name} | {label}"] = lambda name=name, launch=launch: launch(name)
            shape_of[f"{name} | {label}"] = label
        del ref
        if label == "config 1":
            k18 = krw.make_mix_fir_rows_kernel(lowpass(t, 0.4 / decim), decim,
                                               out_tile=OUT_TILE, b_rows=32, device=dev)
            x3, n3 = krw.rows_view(k18, x[0])
            fns["K18 | config 1"] = lambda k18=k18, x3=x3, n3=n3: k18.fn(
                (-hist * word) % (1 << 32), word, x3, n=n3)
            shape_of["K18 | config 1"] = label
            k1 = kmf.make_mix_fir_kernel(lowpass(t, 0.4 / decim), decim, out_tile=OUT_TILE,
                                         b_rows=32, device=dev)
            single = {"kernel, one call | config 1": fns["kernel | config 1"],
                      "wrapper, one call | config 1": lambda k1=k1, x=x: k1.fn(
                          int(w0[0]), word, x[0])}
            for k in single:
                shape_of[k] = label
    times = turns(fns, args.turns, 5)
    times.update(turns(single, 2 * args.turns, 1))
    print(f"{args.turns} turns of 5 launches back to back; every variant but the ablations == "
          f"the kernel (torch.equal)")
    for k, v in times.items():
        m = float(np.median(v))
        b = bounds[shape_of[k]]
        print(f"{k:32s} median {m:.4f} ms (min {min(v):.4f}, max {max(v):.4f}); bound {b:.4f} "
              f"ms, {b / m:.3f} of it")
    return 0


if __name__ == "__main__":
    sys.exit(main())
