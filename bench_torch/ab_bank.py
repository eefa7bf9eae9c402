#!/usr/bin/env python3
"""A/B of the polyphase analysis bank kernels (srcdsp_tpu_torch/csrc/bank.cu:
K12, K13) against their fold + direct-DFT body and against variants of
themselves, on one card.

    PYTHONPATH=. python bench_torch/ab_bank.py [--turns 10]

Builds, from the checkout's sources, one library of bank.cu per variant into
build/ab_bank/<variant>/ (nvcc with the port's flags, all started together):

- ``before``: the fold + direct-DFT body (bench_torch/ab_bank_before/, built
  only here: tiles of 64 frames, the DFT as 8 M^2 flop a frame, one __ldg a
  tap, ten warp reductions per channel and tile for K13, M at most 64);
- ``kernel``: bank.cu as it is (fold from shared taps, the M-point Stockham
  FFT in radix-8 passes, tiles of 64 frames at M = 64, the per-class sums
  owned by one thread each);
- ``radix4``, ``radix2``: FFT passes of radix 4 (3 at M = 64) or 2 (6)
  instead of 8 (2);
- ``dft``: the direct DFT (the body of M that are not powers of two) at
  every M;
- ``tile32``, ``tile16``: at most 32 or 16 frames a tile instead of 64
  (smaller blocks, more of them an SM);
- ``tile128``: up to 128 frames a tile, the budget raised to 160 KB (one
  block an SM at M = 64);
- ``nounroll``: the fold's tap loop not unrolled (by 4);

and two ablations of ``kernel``, which compute something else and are only
timed: ``nofft`` (the fold's output stored as Y, no DFT) and ``nostage``
(nothing loaded: the fold reads whatever the staging buffer holds).

At config 5 (64 channels, 2^19 frames, b_k 512, P = 8, the bench's
prototype) and at 128 channels (2^18 frames), it prints each variant's Y
against ``before``'s (max abs difference and rel L2: the FFT sums in another
order than the direct DFT, so the bits move; ``before`` takes no more than
64 channels, so at 128 the reference is the kernel's plain version), K13's
Y == K12's and the class-major lanes == the standard ones permuted
(torch.equal), and K13's stats against ``before``'s (rel L2). Then times
each in turns (forward, then backward), each turn 5 launches back to back
between CUDA events. Prints the card's name and power limit first, then each
variant's registers and spills as ptxas reports them.
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

from srcdsp_tpu_torch.chains.channelizer import design_prototype  # noqa: E402
from srcdsp_tpu_torch.kernels import _build  # noqa: E402
from srcdsp_tpu_torch.kernels import bank_pallas as kb  # noqa: E402
from srcdsp_tpu_torch.ops.nco import TWO_PI  # noqa: E402

CSRC = REPO / "srcdsp_tpu_torch" / "csrc"
BEFORE = REPO / "bench_torch" / "ab_bank_before"
TILE = "constexpr int kMaxTile = 64;"
BUDGET = "constexpr size_t kBankBudget = 96 * 1024;"
RADIX = "constexpr int kRadix = 8;"
POW2 = "  if ((M & (M - 1)) == 0) {  // kRadix while"
FFT = re.compile(r"    const float2\* Yb = A;\n    if \(g\.npass < 0\) \{.*?\n      Yb = src;\n    \}\n",
                 re.S)
STAGE = re.compile(r"          v\[q\] = i0 \+ q \* \(int\)blockDim\.x < n && "
                   r"\(!tail \|\| g0 \+ col < Lc\) \? __ldg\(src\) : 0\.f;")
UNROLL = "#pragma unroll 4\n      for (int l = 1; l < P; ++l) {"
# variant: [(old, new)] in bank.cu
SUBS = {
    "radix4": [(RADIX, "constexpr int kRadix = 4;")],
    "radix2": [(RADIX, "constexpr int kRadix = 2;")],
    "dft": [(POW2, "  if (false) {  // kRadix while")],
    "tile32": [(TILE, "constexpr int kMaxTile = 32;")],
    "tile16": [(TILE, "constexpr int kMaxTile = 16;")],
    "tile128": [(TILE, "constexpr int kMaxTile = 128;"),
                (BUDGET, "constexpr size_t kBankBudget = 160 * 1024;")],
    "nounroll": [(UNROLL, "      for (int l = 1; l < P; ++l) {")],
    "nofft": [(FFT, "    const float2* Yb = A;\n")],
    "nostage": [(STAGE, "          v[q] = (float)col;")],
}
ABLATIONS = ("nofft", "nostage")
C5_M, C5_FRAMES, C5_BK, C5_SPS, C5_ORDER, C5_TPP = 64, 1 << 19, 512, 4, 4, 8
M128_FRAMES = 1 << 18


def _sub(text: str, old, new: str, where: str) -> str:
    if isinstance(old, re.Pattern):
        if not old.search(text):
            raise SystemExit(f"ab_bank: {old.pattern!r} not in {where}; update the variant")
        return old.sub(lambda _: new, text)
    if old not in text:
        raise SystemExit(f"ab_bank: {old!r} not in {where}; update the variant")
    return text.replace(old, new)


def variants() -> dict[str, dict[str, str]]:
    """{variant: {file name: source text}} for bank.cu and its headers."""
    names = ("bank.cu", "fsk_common.cuh", "fir_ring.cuh")
    kernel = {n: (CSRC / n).read_text() for n in names}
    out = {"before": {n: (BEFORE / n).read_text() for n in ("bank.cu", "fsk_common.cuh")},
           "kernel": kernel}
    for name, subs in SUBS.items():
        files = dict(kernel)
        for old, new in subs:
            files["bank.cu"] = _sub(files["bank.cu"], old, new, f"{name}/bank.cu")
        out[name] = files
    return out


def build(sources: dict[str, dict[str, str]]) -> dict[str, ctypes.CDLL]:
    root = REPO / "build" / "ab_bank"
    procs = {}
    for name, files in sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(d / "bank.o"), str(d / "bank.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ab_bank: nvcc failed on {name}:\n{logs[name]}")
    libs = {}
    for name in sources:
        d = root / name
        subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"), str(d / "bank.o")],
                       check=True)
        for kern, (regs, st, ld) in _build.ptxas_report(logs[name]).items():
            m = re.search(r"bank_kernelILb([01])E", kern)
            if m:
                print(f"{name}: {'K13' if m.group(1) == '1' else 'K12'}: {regs} registers, {st} "
                      f"bytes spill stores, {ld} bytes spill loads")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.srcdsp_bank.argtypes = _build._SIGNATURES["srcdsp_bank"]
        lib.srcdsp_bank.restype = ctypes.c_int
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


def cases(dev: torch.device) -> list[tuple]:
    """(label, M, launch(lib) -> (y, st or None), plain (y, None) or None,
    bound ms); the cases of one M share their input."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out, inputs = [], {}
    for m, frames, stats, cm in ((C5_M, C5_FRAMES, False, False), (C5_M, C5_FRAMES, True, True),
                                 (C5_M, C5_FRAMES, True, False), (128, M128_FRAMES, False, False)):
        if m not in inputs:
            bk = kb._Bank(design_prototype(m, C5_TPP), m, C5_BK, None, dev)
            x = torch.randn((2, m, bk.hist_cols + frames), device=dev, generator=gen)
            inputs[m] = bk, x
        bk, x = inputs[m]
        y = torch.empty((2 * m, frames), device=dev)
        st = torch.empty((frames // C5_BK, m, kb.STATS_LANES), device=dev) if stats else None
        ang = float(np.float32(TWO_PI / C5_SPS))

        def launch(lib, bk=bk, x=x, y=y, st=st, m=m, frames=frames, stats=stats, cm=cm):
            rc = lib.srcdsp_bank(x.data_ptr(), bk.h.data_ptr(), bk.tw.data_ptr(), y.data_ptr(),
                                 st.data_ptr() if stats else None, m, bk.p1 - 1, x.shape[-1],
                                 bk.hist_cols, frames, C5_BK, C5_SPS, C5_ORDER, ang, int(cm),
                                 int(stats), _build.stream_handle(x))
            if rc:
                raise SystemExit(f"ab_bank: M {m} launch failed with cudaError_t {rc}")
            return y, st

        plain = (kb.bank_plain(x, bk.e_comb_t, m, bk.p1, bk.hist_cols), None) if m > 64 else None
        nbytes = (x.numel() + y.numel() + (st.numel() if stats else 0)) * 4
        label = (f"K{13 if stats else 12}{' class-major' if cm else ''} | M {m}, "
                 f"{frames} frames")
        out.append((label, m, launch, plain, nbytes / 3.35e12 * 1e3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_bank: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(variants())
    dev = torch.device("cuda", 0)
    fns, bounds, ok = {}, {}, True
    y12, y13c = {}, {}
    perm = kb.class_major_index(C5_BK, C5_SPS, dev)
    for label, m, launch, plain, bound in cases(dev):
        if plain is None:
            ref = tuple(None if t is None else t.clone() for t in launch(libs["before"]))
        else:
            ref = plain
        for name, lib in libs.items():
            if name == "before" and m > 64:
                continue
            y, st = launch(lib)
            torch.cuda.synchronize()
            if name not in ABLATIONS and name != "before":
                d = float((y - ref[0]).abs().max())
                rel = float(torch.linalg.norm(y - ref[0]) / torch.linalg.norm(ref[0]))
                ok &= rel < 1e-5
                msg = f"{label}: {name} Y against {'before' if plain is None else 'plain'}: " \
                      f"max abs {d:.3e}, rel L2 {rel:.3e}"
                if st is not None and ref[1] is not None:
                    srel = float(torch.linalg.norm(st - ref[1]) / torch.linalg.norm(ref[1]))
                    ok &= srel < 1e-5
                    msg += f"; stats rel L2 {srel:.3e}"
                if label.startswith("K12 |") and m == C5_M:
                    y12[name] = y.clone()
                elif label.startswith("K13 class-major"):
                    y13c[name] = (y.clone(), st.clone())
                elif label.startswith("K13 |"):
                    same = torch.equal(y, y12[name])
                    cm = y.reshape(2 * m, -1, C5_BK)[..., perm].reshape(y.shape)
                    perm_ok = torch.equal(y13c[name][0], cm) and torch.equal(y13c[name][1], st)
                    ok &= same and perm_ok
                    msg += (f"; Y == K12's (torch.equal): {same}; class-major == standard "
                            f"permuted, stats equal (torch.equal): {perm_ok}")
                print(msg)
            fns[f"{name} | {label}"] = lambda lib=lib, launch=launch: launch(lib)
            bounds[f"{name} | {label}"] = bound
        del ref
    times = turns(fns, args.turns, 5)
    print(f"{args.turns} turns of 5 launches back to back; every variant within rel L2 1e-5 "
          f"and K13 == K12: {ok}")
    for k, v in times.items():
        med = float(np.median(v))
        b = bounds[k]
        print(f"{k:48s} median {med:.4f} ms (min {min(v):.4f}, max {max(v):.4f}); bound {b:.4f} "
              f"ms, {b / med:.3f} of it")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
