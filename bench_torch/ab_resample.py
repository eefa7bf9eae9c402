#!/usr/bin/env python3
"""A/B of the mix + L/M resampler kernels (srcdsp_tpu_torch/csrc/resample.cu:
K8, K8 mc, K9 f32 and bf16) against their one-output-a-thread body and
against variants of themselves, on one card.

    PYTHONPATH=. python bench_torch/ab_resample.py [--turns 10]

Builds, from the checkout's sources, one library of resample.cu per variant
into build/ab_resample/<variant>/ (nvcc with the port's flags, all started
together):

- ``before``: the one-output-a-thread body (bench_torch/ab_resample_before/,
  built only here: one block a row of OT outputs, a thread one output at a
  time, three shared loads per two FMAs);
- ``kernel``: resample.cu as it is (the L classes on the register ring of
  fir_ring.cuh at K1's shapes: R = 4 in blocks of 256 at M = 4, 8 in
  blocks of 128 at M = 1 and 2; the output tile);
- ``t128``: blocks of 128 threads at M = 4 instead of 256;
- ``r8``: 8 outputs a thread in blocks of 128 at every M (it spills at
  M = 4);
- ``r4``: 4 outputs a thread in blocks of 256 at every M (config 2 runs
  M = 4, so only its ptxas lines differ);
- ``direct``: each thread stores its outputs straight to device memory (L
  apart) instead of through the shared output tile;
- ``w4``: a shared-memory budget of 48 KB, so 4 warps a class (1536
  outputs a block) instead of 8;
- ``batch4``: 4 samples a thread in flight while staging instead of 8;

and two ablations of ``kernel``, which compute something else and are only
timed: ``nofir`` (the window staged, no ring) and ``nostage`` (zeros written
to the window, no loads).

Every variant but the ablations must give ``before``'s outputs bit for bit;
it prints torch.equal for each at config 2 (the 429 combined taps of the
128-tap FIR and the 3/4 resampler, out_tile 384): K8 over one channel of
33,521,664 samples, K8 mc over 4 channels x 8,380,416, K9 over K6 frames of
the one channel (out_tile 1152 f32, 2304 bf16), and K9 f32 == K8. Then
times each in turns (forward, then backward), each turn 5 launches back to
back between CUDA events. Prints the card's name and power limit first, then
each variant's registers and spills as ptxas reports them.
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
from srcdsp_tpu_torch.kernels import mixfir_preframed as kpf  # noqa: E402
from srcdsp_tpu_torch.kernels import resample_pallas as krs  # noqa: E402
from srcdsp_tpu_torch.ops.nco import freq_to_word  # noqa: E402
from srcdsp_tpu_torch.ops.window import lowpass  # noqa: E402

CSRC = REPO / "srcdsp_tpu_torch" / "csrc"
BEFORE = REPO / "bench_torch" / "ab_resample_before"
SHAPE = "using ResampleShape = FirShape<D>;"
RING = re.compile(r"class_ring<S>\(o, sh \+ j \* g\.tpc.*?ai\);", re.S)
NOFIR = "for (int k = 0; k < R; ++k) { ar[k] = sr[task_lane(g) + k]; ai[k] = si[task_lane(g) + k]; }"
STAGE = re.compile(r"stage_mixed<Src, kBatch>[^;]*;")
ZEROS = ("for (int i = threadIdx.x; i < g.span; i += blockDim.x) "
         "sr[fir_pad(i, S::kLog2Stride)] = si[fir_pad(i, S::kLog2Stride)] = 0.f;")
TILE = re.compile(r"    const int p = task_lane\(g\) \* \(R \* up \+ 1\) \+ j;.*?\n}\n\n"
                  r"template <int D, class Src>\nint launch\(", re.S)
DIRECT = """#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long J = j0 + (long long)(task_lane(g) * R + k) * up + j;
      if (J < total) {
        yr[(long long)c * total + J] = ar[k];
        yi[(long long)c * total + J] = ai[k];
      }
    }
  }
}

template <int D, class Src>
int launch("""
# variant: [(file, old, new)]
SUBS = {
    "t128": [("resample.cu", SHAPE, "using ResampleShape = RingShape<D, D == 4 ? 4 : 8, 128>;")],
    "r8": [("resample.cu", SHAPE, "using ResampleShape = RingShape<D, 8, 128>;")],
    "r4": [("resample.cu", SHAPE, "using ResampleShape = RingShape<D, 4, 256>;")],
    "direct": [("resample.cu", TILE, DIRECT)],
    "w4": [("resample.cu", "constexpr size_t kSmemBudget = 96 * 1024;",
            "constexpr size_t kSmemBudget = 48 * 1024;")],
    "batch4": [("resample.cu", "kStageBatch / 2 : kStageBatch;",
                "kStageBatch / 2 : kStageBatch / 2;")],
    "nofir": [("resample.cu", RING, NOFIR)],
    "nostage": [("resample.cu", STAGE, ZEROS)],
}
ABLATIONS = ("nofir", "nostage")
ENTRIES = ("srcdsp_mix_resample", "srcdsp_resample_preframed")
UP, DOWN, OT = 3, 4, 384
C2_SAMPLES, C2_CHANNELS, C2_CHUNK = 682 * 12288 * 4, 4, 682 * 12288


def _sub(text: str, old, new: str, where: str) -> str:
    if isinstance(old, re.Pattern):
        if not old.search(text):
            raise SystemExit(f"ab_resample: {old.pattern!r} not in {where}; update the variant")
        return old.sub(lambda _: new, text)
    if old not in text:
        raise SystemExit(f"ab_resample: {old!r} not in {where}; update the variant")
    return text.replace(old, new)


def variants() -> dict[str, dict[str, str]]:
    """{variant: {file name: source text}} for resample.cu and its headers."""
    names = ("resample.cu", "fsk_common.cuh", "fir_ring.cuh")
    kernel = {n: (CSRC / n).read_text() for n in names}
    out = {"before": {n: (BEFORE / n).read_text() for n in ("resample.cu", "fsk_common.cuh")},
           "kernel": kernel}
    for name, subs in SUBS.items():
        files = dict(kernel)
        for f, old, new in subs:
            files[f] = _sub(files[f], old, new, f"{name}/{f}")
        out[name] = files
    return out


def build(sources: dict[str, dict[str, str]]) -> dict[str, ctypes.CDLL]:
    root = REPO / "build" / "ab_resample"
    procs = {}
    for name, files in sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(d / "resample.o"),
             str(d / "resample.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ab_resample: nvcc failed on {name}:\n{logs[name]}")
    libs = {}
    for name in sources:
        d = root / name
        subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"), str(d / "resample.o")],
                       check=True)
        for kern, (regs, st, ld) in _build.ptxas_report(logs[name]).items():
            m = re.search(r"resample_kernelI(?:Li(\d)E)?N6srcdsp(\d+)(\w+?)I(f|13__nv)", kern)
            if m:
                d_ = f" D={m.group(1)}" if m.group(1) else ""
                src = m.group(3) + ("<bf16>" if m.group(4) != "f" else "<f32>")
                print(f"{name}: resample{d_} {src}: {regs} registers, {st} bytes spill stores, "
                      f"{ld} bytes spill loads")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for e in ENTRIES:
            fn = getattr(lib, e)
            fn.argtypes = _build._SIGNATURES[e]
            fn.restype = ctypes.c_int
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
    """(label, launch(lib) -> outputs (compared bit for bit), bound ms)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    hc = krs.combine_fir_resample_taps(lowpass(128, 0.2), lowpass(48, 0.3), UP)
    hist, _ = krs.resample_geometry(len(hc), UP, DOWN, OT)
    taps_ph = torch.as_tensor(krs.phase_taps(hc, UP), device=dev)
    q = taps_ph.shape[1]
    word = int(freq_to_word(0.07))
    words = np.asarray([(word + 7919 * c) % (1 << 32) for c in range(C2_CHANNELS)], np.uint32)
    words0 = ((-hist * words.astype(np.int64)) % (1 << 32)).astype(np.uint32)
    x = torch.randn((C2_CHANNELS, 2, hist + C2_SAMPLES), device=dev, generator=gen)
    x[..., :hist] = 0.0
    x1 = x[0].contiguous()
    chunk = x[..., :hist + C2_CHUNK].contiguous()
    del x
    out = []

    def check(rc, label):
        if rc:
            raise SystemExit(f"ab_resample: {label} failed with cudaError_t {rc}")

    def bound(outputs, nbytes):  # the larger of the f32 multiply-adds and the bytes
        return max(outputs * q * 4 / 67e12, nbytes / 3.35e12) * 1e3

    nt1 = C2_SAMPLES * UP // (DOWN * OT)
    y1 = torch.empty((2, nt1, OT), device=dev)

    def k8(lib):
        check(lib.srcdsp_mix_resample(x1.data_ptr(), taps_ph.data_ptr(), y1[0].data_ptr(),
                                      y1[1].data_ptr(), words0[:1].ctypes.data,
                                      words[:1].ctypes.data, 1, x1.shape[-1], nt1, OT, UP, DOWN,
                                      q, hist, _build.stream_handle(x1)), "K8")
        return (y1,)

    out.append(("K8 | config 2, 1 ch", k8, bound(nt1 * OT, (x1.numel() + y1.numel()) * 4)))
    ntc = C2_CHUNK * UP // (DOWN * OT)
    yc = torch.empty((2, C2_CHANNELS, ntc, OT), device=dev)

    def k8mc(lib):
        check(lib.srcdsp_mix_resample(chunk.data_ptr(), taps_ph.data_ptr(), yc[0].data_ptr(),
                                      yc[1].data_ptr(), words0.ctypes.data, words.ctypes.data,
                                      C2_CHANNELS, chunk.shape[-1], ntc, OT, UP, DOWN, q, hist,
                                      _build.stream_handle(chunk)), "K8 mc")
        return (yc,)

    out.append(("K8 mc | config 2 chunk", k8mc,
                bound(C2_CHANNELS * ntc * OT, (chunk.numel() + yc.numel()) * 4)))
    for dt, sfx, ot9 in ((torch.float32, "", 1152), (torch.bfloat16, " bf16", 2304)):
        stride = ot9 * DOWN // UP
        span = stride + hist
        fr = kpf.frame_planes(x1.to(dt), stride, span)
        xr_f, xi_f = fr[0].contiguous(), fr[1].contiguous()
        del fr
        nt9 = xr_f.shape[0]
        y9 = torch.empty((2, nt9, ot9), device=dev)
        b16 = int(dt == torch.bfloat16)

        def k9(lib, xr_f=xr_f, xi_f=xi_f, y9=y9, nt9=nt9, span=span, ot9=ot9, b16=b16,
               label="K9" + sfx):
            check(lib.srcdsp_resample_preframed(xr_f.data_ptr(), xi_f.data_ptr(),
                                                taps_ph.data_ptr(), y9[0].data_ptr(),
                                                y9[1].data_ptr(), int(words0[0]), int(words[0]),
                                                nt9, span, ot9, UP, DOWN, q, hist, b16,
                                                _build.stream_handle(xr_f)), label)
            return (y9,)

        out.append(("K9" + sfx + " | config 2, 1 ch", k9,
                    bound(nt9 * ot9, 2 * xr_f.numel() * xr_f.element_size() + y9.numel() * 4)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_resample: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(variants())
    dev = torch.device("cuda", 0)
    fns, bounds, all_equal = {}, {}, True
    k8_out = {}
    for label, launch, bound in cases(dev):
        ref = [t.clone() for t in launch(libs["before"])]
        for name, lib in libs.items():
            got = launch(lib)
            torch.cuda.synchronize()
            if name not in ABLATIONS and name != "before":
                equal = all(torch.equal(a, b) for a, b in zip(got, ref))
                all_equal &= equal
                print(f"{label}: {name} == before (torch.equal): {equal}")
            if label.startswith("K8 |") and name == "kernel":
                k8_out["K8"] = got[0].clone()
            if label.startswith("K9 |") and name == "kernel":
                same = torch.equal(got[0].reshape(2, -1), k8_out["K8"].reshape(2, -1))
                all_equal &= same
                print(f"{label}: kernel K9 == kernel K8 (torch.equal): {same}")
            fns[f"{name} | {label}"] = lambda lib=lib, launch=launch: launch(lib)
            bounds[f"{name} | {label}"] = bound
        del ref
    times = turns(fns, args.turns, 5)
    print(f"{args.turns} turns of 5 launches back to back; every variant but the ablations == "
          f"before: {all_equal}")
    for k, v in times.items():
        m = float(np.median(v))
        b = bounds[k]
        print(f"{k:40s} median {m:.4f} ms (min {min(v):.4f}, max {max(v):.4f}); bound {b:.4f} "
              f"ms, {b / m:.3f} of it")
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
