#!/usr/bin/env python3
"""A/B of the row-form mix + FIR kernel K18 (srcdsp_tpu_torch/csrc/rows.cu)
against its one-output-a-thread body, against variants of itself and beside
K1, on one card.

    PYTHONPATH=. python bench_torch/ab_rows.py [--turns 10]

Builds, from the checkout's sources, one library of rows.cu per variant into
build/ab_rows/<variant>/ (nvcc with the port's flags, all started together):

- ``before``: the one-output-a-thread body (bench_torch/ab_rows_before/:
  one block a row of OT outputs, real_dot, three shared loads per two FMAs,
  the factored mix left to nvcc's contraction);
- ``kernel``: rows.cu as it is (K1's register ring of fir_ring.cuh over the
  flat stream, the window staged with the factored mix RowMix);
- ``wordmix``: the window staged with K1's mix (one sincospif a sample, its
  u32 word) instead of the factored one;

and two ablations of ``kernel``, which compute something else and are only
timed: ``nofir`` (the window staged, no ring) and ``nostage`` (zeros written
to the window, no loads, no mix).

Prints, at config-1 shape (2^26 samples, lowpass(64, 0.2), decim 2, OT 512,
b_rows 32) and at decim 4 (lowpass(33, 0.1), OT 256): ``kernel`` against
``before`` (torch.equal, else the max abs difference), and ``kernel``,
``before`` and ``wordmix`` against the plain version and against K1 (rel
L2; the contract is 2e-6). Then times each, and K1 on the same stream, in
turns (forward, then backward), each turn 5 launches back to back between
CUDA events, and prints K1 / K18. Prints the card's name and power limit
first, then each variant's registers and spills as ptxas reports them.
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
from srcdsp_tpu_torch.kernels import mixfir_rows as krw  # noqa: E402
from srcdsp_tpu_torch.ops.nco import freq_to_word  # noqa: E402
from srcdsp_tpu_torch.ops.window import lowpass  # noqa: E402

CSRC = REPO / "srcdsp_tpu_torch" / "csrc"
BEFORE = REPO / "bench_torch" / "ab_rows_before"
STAGE = re.compile(r"stage_window<true, Planes<float>, PaddedIndex, kStageBatch, RowMix>\(.*?\);",
                   re.S)
WORDMIX = ("stage_window<true, Planes<float>, PaddedIndex, kStageBatch>(Planes<float>{x, L}, 0, "
           "base, g.span, w0, dw, sr, si, PaddedIndex{S::kLog2Stride});")
ZEROS = ("for (int i = threadIdx.x; i < g.span; i += blockDim.x) "
         "sr[fir_pad(i, S::kLog2Stride)] = si[fir_pad(i, S::kLog2Stride)] = 0.f;")
RING = re.compile(r"ring_block<S, false>\(sh, nullptr, sr, si, [^;]*;")
NOFIR = ("for (int k = 0; k < R; ++k) { ar[k] = sr[threadIdx.x * R + k]; "
         "ai[k] = si[threadIdx.x * R + k]; }")
# variant: [(old, new)] in rows.cu
SUBS = {"wordmix": [(STAGE, WORDMIX)], "nofir": [(RING, NOFIR)], "nostage": [(STAGE, ZEROS)]}
ABLATIONS = ("nofir", "nostage")
SAMPLES = 1 << 26
CASES = (("config 1, decim 2", 64, 0.2, 2, 512), ("decim 4", 33, 0.1, 4, 256))


def _sub(text: str, old, new: str, where: str) -> str:
    if isinstance(old, re.Pattern):
        if not old.search(text):
            raise SystemExit(f"ab_rows: {old.pattern!r} not in {where}; update the variant")
        return old.sub(lambda _: new, text)
    if old not in text:
        raise SystemExit(f"ab_rows: {old!r} not in {where}; update the variant")
    return text.replace(old, new)


def variants() -> dict[str, dict[str, str]]:
    """{variant: {file name: source text}} for rows.cu and its headers."""
    names = ("rows.cu", "fsk_common.cuh", "fir_ring.cuh")
    kernel = {n: (CSRC / n).read_text() for n in names}
    out = {"before": {n: (BEFORE / n).read_text() for n in ("rows.cu", "fsk_common.cuh")},
           "kernel": kernel}
    for name, subs in SUBS.items():
        files = dict(kernel)
        for old, new in subs:
            files["rows.cu"] = _sub(files["rows.cu"], old, new, name)
        out[name] = files
    return out


def build(sources: dict[str, dict[str, str]]) -> dict[str, ctypes.CDLL]:
    root = REPO / "build" / "ab_rows"
    procs = {}
    for name, files in sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(d / "rows.o"), str(d / "rows.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ab_rows: nvcc failed on {name}:\n{logs[name]}")
    libs = {}
    for name in sources:
        d = root / name
        subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"), str(d / "rows.o")],
                       check=True)
        for kern, (regs, st, ld) in _build.ptxas_report(logs[name]).items():
            m = re.search(r"rows_kernel(?:ILi(\d)E)?", kern)
            if m:
                d_ = f" D={m.group(1)}" if m.group(1) else ""
                print(f"{name}: rows_kernel{d_}: {regs} registers, {st} bytes spill stores, "
                      f"{ld} bytes spill loads")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.srcdsp_mixfir_rows.argtypes = _build._SIGNATURES["srcdsp_mixfir_rows"]
        lib.srcdsp_mixfir_rows.restype = ctypes.c_int
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


def _rel(a, b) -> float:
    ga, gb = torch.complex(*a).reshape(-1), torch.complex(*b).reshape(-1)
    return float(torch.linalg.norm(ga - gb) / torch.linalg.norm(gb))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_rows: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(variants())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    main_lib = _build.load()
    fns, ok = {}, True
    for label, t, cutoff, decim, ot in CASES:
        taps_np = lowpass(t, cutoff)
        taps = torch.as_tensor(taps_np, device=dev)
        word = int(freq_to_word(0.11))
        kr = krw.make_mix_fir_rows_kernel(taps_np, decim, out_tile=ot, b_rows=32, device=dev)
        hist = kr.hist
        w0 = (-hist * word) % (1 << 32)
        x = torch.randn((2, hist + SAMPLES), device=dev, generator=gen)
        x[:, :hist] = 0.0
        x3, n = krw.rows_view(kr, x)
        nt = n // (ot * decim)
        stream = _build.stream_handle(x3)

        def k18(lib, x3=x3, taps=taps, nt=nt, ot=ot, decim=decim, t=t, hist=hist, w0=w0,
                word=word, stream=stream, name="K18"):
            y = torch.empty((2, nt, ot), device=dev)
            rc = lib.srcdsp_mixfir_rows(x3.data_ptr(), taps.data_ptr(), y[0].data_ptr(),
                                        y[1].data_ptr(), w0, word, x3.shape[1] * 128, nt, ot,
                                        decim, t, hist, stream)
            if rc:
                raise SystemExit(f"ab_rows: {name} failed with cudaError_t {rc}")
            return y[0], y[1]

        words0 = np.asarray([w0], np.uint32)
        dwords = np.asarray([word], np.uint32)
        x1 = x[None].contiguous()

        def k1(x1=x1, taps=taps, nt=nt, ot=ot, decim=decim, t=t, hist=hist, words0=words0,
               dwords=dwords):
            y = torch.empty((2, nt, ot), device=dev)
            rc = main_lib.srcdsp_mixfir(x1.data_ptr(), taps.data_ptr(), 0, y[0].data_ptr(),
                                        y[1].data_ptr(), words0.ctypes.data, dwords.ctypes.data,
                                        1, x1.shape[-1], nt, ot, decim, t, hist,
                                        _build.stream_handle(x1))
            _build.check(rc, "mixfir")
            return y[0], y[1]

        plain = krw.mix_fir_rows_plain(w0, word, x3, taps, decim, ot, hist, n)
        y1 = k1()
        before = k18(libs["before"])
        for name, lib in libs.items():
            got = k18(lib, name=name)
            torch.cuda.synchronize()
            if name not in ABLATIONS:
                rp, r1 = _rel(got, plain), _rel(got, y1)
                ok &= rp < 2e-6 and r1 < 2e-6
                line = f"{label}: {name} rel L2 against plain {rp:.3e}, against K1 {r1:.3e}"
                if name != "before":
                    same = all(torch.equal(a, b) for a, b in zip(got, before))
                    diff = max(float((a - b).abs().max()) for a, b in zip(got, before))
                    line += f"; == before (torch.equal): {same}, max abs diff {diff:.3e}"
                print(line)
            fns[f"{name} | {label}"] = lambda lib=lib, k18=k18: k18(lib)
        fns[f"K1 | {label}"] = k1
        del plain, y1, before
    times = turns(fns, args.turns, 5)
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"{args.turns} turns of 5 launches back to back; kernel, before and wordmix within rel "
          f"L2 2e-6 of plain and K1: {ok}")
    for k, v in times.items():
        print(f"{k:40s} median {med[k]:.4f} ms (min {min(v):.4f}, max {max(v):.4f})")
    for label, *_ in CASES:
        print(f"{label}: K1 / K18 {med[f'K1 | {label}'] / med[f'kernel | {label}']:.3f}, K1 / "
              f"before {med[f'K1 | {label}'] / med[f'before | {label}']:.3f}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
