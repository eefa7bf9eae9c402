#!/usr/bin/env python3
"""A/B of the complex-taps and FSK front-end kernels (srcdsp_tpu_torch/csrc/
ctaps.cu: K4, K5, K17; csrc/fsk.cu: K2, K3, K7) against their one-output-a-
thread bodies and against variants of themselves, on one card.

    PYTHONPATH=. python bench_torch/ab_ctaps.py [--turns 10]

Builds, from the checkout's sources, one library of ctaps.cu and fsk.cu per
variant into build/ab_ctaps/<variant>/ (nvcc with the port's flags, all
started together):

- ``before``: the one-output-a-thread bodies (bench_torch/ab_ctaps_before/,
  built only here: a thread computes one output at a time through
  ctaps_dot, one block a row);
- ``kernel``: ctaps.cu and fsk.cu as they are (the register ring of
  fir_ring.cuh);
- ``c4t256``: K4, K5 and K17 at 4 outputs a thread in blocks of 256 at
  every decim, instead of 8 in blocks of 128 at decim 1 and 2;
- ``f4t128``, ``f4t128r80``, ``f8t128r80``: K3 and K7 at 4 outputs a
  thread in blocks of 128 with 64 or 80 registers (80: 6 blocks an SM), or
  at 8 with 80, instead of 4 in blocks of 256 with 64;
- ``fbatch8``: K2 stages 8 samples a thread, K3 and K7 8 bf16 pairs, instead
  of 4 (it spills);
- ``k2t128r80``: K2 at decim 4 in blocks of 128 threads with 80 registers
  (6 blocks an SM) instead of K1's shape, 256 threads at 64;
- ``k2inline``: K2's predecessor chain inlined, not a call (it spills);
- ``single``: bf16 staged one sample a load, 16 in flight a thread,
  instead of 8 pairs of samples, one 4-byte load a pair;

and four ablations of ``kernel``, which compute something else and are only
timed: ``nofir`` (the window staged, no FIR), ``nostage`` (zeros written
to the window, no loads), ``nochain`` (no FSK predecessor chain: thread 0's
y[J-1] left as it was) and ``noatan`` (the FSK discriminator's atan2f
replaced by a product).

Every variant but the ablations must give ``before``'s y (K4, K5, K17) and
d (K2, K3, K7) bit for bit; it prints torch.equal for each, at config 1
(2^26 samples, 64 taps, decim 2, out_tile 512; K4 and K5 in f32 and bf16,
K17) and one config-4 chunk (32 x 2^22, 64 taps, decim 4, sps 8,
class-major; K2, K3 and K7, K3 and K7 in f32 and bf16), and st's largest
difference from ``before`` (its sums run in another order). Then times each
in turns (forward, then backward), each turn 5 launches back to back
between CUDA events. Prints the card's name and power limit first, then
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
from srcdsp_tpu_torch.kernels import fsk_ctaps as kct  # noqa: E402
from srcdsp_tpu_torch.kernels import mixfir_preframed as kpf  # noqa: E402
from srcdsp_tpu_torch.ops.nco import freq_to_word  # noqa: E402
from srcdsp_tpu_torch.ops.window import lowpass  # noqa: E402

CSRC = REPO / "srcdsp_tpu_torch" / "csrc"
BEFORE = REPO / "bench_torch" / "ab_ctaps_before"
CTAPS_SHAPE = "using CtapsShape = RingShape<D, D == 4 ? 4 : 8, D == 4 ? 256 : 128>;"
FSK_SHAPE = "using FskCtapsShape = RingShape<D, 4, 256>;"
FSK_BATCH = "CTAPS && D && Src::kBytes == 4 ? kStageBatch : kStageBatch / 2"
K2_SHAPE = "using FskShape = std::conditional_t<CTAPS, FskCtapsShape<D>, FirShape<D>>;"
K2_CHAIN = "        real_chain_call(hr, sr, si, hist + g.lead - dm, T, L2S, lr, li);"
PAIRS = "  if constexpr (kWide && Src::kPaired) {"
CTAPS_FIR = "ring_block<S, true>(hr, hi, sr, si, threadIdx.x * R * d + hist + g.lead, g.tp, T, ar, ai);"
FSK_FIR = "ring_block<S, CTAPS>(hr, hi, sr, si, tid * R * dm + hist + g.lead, g.tp, T, ar, ai);"
NOFIR = "for (int k = 0; k < R; ++k) { ar[k] = sr[threadIdx.x * R + k]; ai[k] = si[threadIdx.x * R + k]; }"
STAGE = re.compile(r"stage_window<[^;]*;")
CHAIN = re.compile(r"if \(tid == 0\) \{\n.*?\n    \}\n", re.S)
ATAN = "dv = atan2f(zi, zr) * inv_two_pi;"
ZEROS = ("for (int i = threadIdx.x; i < g.span; i += blockDim.x) "
         "sr[fir_pad(i, S::kLog2Stride)] = si[fir_pad(i, S::kLog2Stride)] = 0.f;")
# variant: [(file, old, new)]
SUBS = {
    "c4t256": [("fir_ring.cuh", CTAPS_SHAPE, "using CtapsShape = RingShape<D, 4, 256>;")],
    "f4t128r80": [("fsk.cu", FSK_SHAPE, "using FskCtapsShape = RingShape<D, 4, 128, 6>;")],
    "f4t128": [("fsk.cu", FSK_SHAPE, "using FskCtapsShape = RingShape<D, 4, 128>;")],
    "f8t128r80": [("fsk.cu", FSK_SHAPE, "using FskCtapsShape = RingShape<D, 8, 128, 6>;")],
    "fbatch8": [("fsk.cu", FSK_BATCH, "D ? kStageBatch : kStageBatch / 2")],
    "k2t128r80": [("fsk.cu", K2_SHAPE, "using FskShape = std::conditional_t<CTAPS, "
                   "FskCtapsShape<D>, std::conditional_t<D == 4, RingShape<4, 4, 128, 6>, "
                   "FirShape<D>>>;")],
    "k2inline": [("fsk.cu", K2_CHAIN, "        chain_output<false>(hr, hi, sr, si, "
                  "hist + g.lead - dm, T, L2S, lr, li);")],
    "single": [("fsk_common.cuh", PAIRS, "  if constexpr (false) {")],
    "geomk": [("fsk.cu", "               RingGeometry g, int rows_b) {",
               "               RingGeometry, int rows_b) {\n  const RingGeometry g = "
               "ring_geometry<FskShape<CTAPS, D>>(D ? D : decim, T, hist, D ? D : decim);")],
    "nofir": [("ctaps.cu", CTAPS_FIR, NOFIR), ("fsk.cu", FSK_FIR, NOFIR)],
    "nostage": [("ctaps.cu", STAGE, ZEROS), ("fsk.cu", STAGE, ZEROS)],
    "nochain": [("fsk.cu", CHAIN, "")],
    "noatan": [("fsk.cu", ATAN, "dv = zi * zr * inv_two_pi;")],
}
ABLATIONS = ("nofir", "nostage", "nochain", "noatan")
ENTRIES = ("srcdsp_mixfir_ctaps", "srcdsp_ctaps_preframed", "srcdsp_ctaps_aligned",
           "srcdsp_fsk_fused", "srcdsp_fsk_ctaps", "srcdsp_fsk_preframed")
OUT_TILE, SPS, C4 = 512, 8, 32


def _sub(text: str, old, new: str, where: str) -> str:
    if isinstance(old, re.Pattern):
        if not old.search(text):
            raise SystemExit(f"ab_ctaps: {old.pattern!r} not in {where}; update the variant")
        return old.sub(lambda _: new, text)
    if old not in text:
        raise SystemExit(f"ab_ctaps: {old!r} not in {where}; update the variant")
    return text.replace(old, new)


def variants() -> dict[str, dict[str, str]]:
    """{variant: {file name: source text}} for ctaps.cu, fsk.cu and their headers."""
    names = ("ctaps.cu", "fsk.cu", "fsk_common.cuh", "fir_ring.cuh")
    kernel = {n: (CSRC / n).read_text() for n in names}
    out = {"before": {n: (BEFORE / n).read_text() for n in ("ctaps.cu", "fsk.cu",
                                                            "fsk_common.cuh")},
           "kernel": kernel}
    for name, subs in SUBS.items():
        files = dict(kernel)
        for f, old, new in subs:
            files[f] = _sub(files[f], old, new, f"{name}/{f}")
        out[name] = files
    return out


def build(sources: dict[str, dict[str, str]]) -> dict[str, ctypes.CDLL]:
    root = REPO / "build" / "ab_ctaps"
    procs = {}
    for name, files in sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        for f, text in files.items():
            (d / f).write_text(text)
        for cu in ("ctaps.cu", "fsk.cu"):
            procs[name, cu] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(d / (cu + ".o")),
                 str(d / cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for (name, cu), p in procs.items():
        logs[name, cu] = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ab_ctaps: nvcc failed on {name}/{cu}:\n{logs[name, cu]}")
    libs = {}
    for name in sources:
        d = root / name
        subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"),
                        str(d / "ctaps.cu.o"), str(d / "fsk.cu.o")], check=True)
        for kern, (regs, st, ld) in _build.ptxas_report(
                logs[name, "ctaps.cu"] + logs[name, "fsk.cu"]).items():
            m = re.search(r"(ctaps|fsk)_kernelI(?:Lb([01])E)?Li(\d)EN6srcdsp(\d+)(\w+?)I(f|13__nv)",
                          kern)
            if m:
                body = "ctaps" if m.group(1) == "ctaps" else ("fsk K2" if m.group(2) == "0"
                                                               else "fsk K3/K7")
                src = m.group(5) + ("<bf16>" if m.group(6) != "f" else "<f32>")
                print(f"{name}: {body} D={m.group(3)} {src}: {regs} registers, {st} bytes spill "
                      f"stores, {ld} bytes spill loads")
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
    """(label, launch(lib) -> outputs (compared bit for bit), extra outputs, bound ms)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    hist = 128

    def check(rc, label):
        if rc:
            raise SystemExit(f"ab_ctaps: {label} failed with cudaError_t {rc}")

    # config 1: K4, K5 (f32, bf16), K17
    word = int(freq_to_word(0.11))
    w0 = (-hist * word) % (1 << 32)
    n1 = 1 << 26
    gr, gi, _ = kct.ctaps_host(lowpass(64, 0.2), [word], 2)
    gr, gi = (torch.as_tensor(a[0], device=dev) for a in (gr, gi))
    nt1 = n1 // (OUT_TILE * 2)
    x1 = torch.randn((2, hist + n1), device=dev, generator=gen)
    yr1 = torch.empty((nt1, OUT_TILE), device=dev)
    yi1 = torch.empty_like(yr1)
    stride1, span1 = OUT_TILE * 2, OUT_TILE * 2 + hist
    for dt, sfx in ((torch.float32, ""), (torch.bfloat16, " bf16")):
        xin = x1.to(dt)
        fr = kpf.frame_planes(xin, stride1, span1)
        b16 = int(dt == torch.bfloat16)
        nbytes = (xin.numel() * xin.element_size() + 2 * yr1.numel() * 4) / 3.35e12 * 1e3

        def k4(lib, xin=xin, b16=b16, label="K4" + sfx):
            check(lib.srcdsp_mixfir_ctaps(xin.data_ptr(), gr.data_ptr(), gi.data_ptr(),
                                          yr1.data_ptr(), yi1.data_ptr(), w0, word,
                                          xin.shape[-1], nt1, OUT_TILE, 2, 64, hist, b16,
                                          _build.stream_handle(xin)), label)
            return yr1, yi1

        def k5(lib, fr=fr, b16=b16, label="K5" + sfx):
            check(lib.srcdsp_ctaps_preframed(fr[0].data_ptr(), fr[1].data_ptr(), gr.data_ptr(),
                                             gi.data_ptr(), yr1.data_ptr(), yi1.data_ptr(), w0,
                                             word, nt1, span1, OUT_TILE, 2, 64, hist, b16,
                                             _build.stream_handle(fr)), label)
            return yr1, yi1

        out.append(("K4" + sfx + " | config 1", k4, (), nbytes))
        out.append(("K5" + sfx + " | config 1", k5, (),
                    (fr.numel() * fr.element_size() + 2 * yr1.numel() * 4) / 3.35e12 * 1e3))

    def k17(lib):
        check(lib.srcdsp_ctaps_aligned(x1.data_ptr(), x1[:, hist:].data_ptr(), gr.data_ptr(),
                                       gi.data_ptr(), yr1.data_ptr(), yi1.data_ptr(), w0, word,
                                       x1.stride(0), x1.stride(0), n1, nt1, OUT_TILE, 2, 64,
                                       hist, _build.stream_handle(x1)), "K17")
        return yr1, yi1

    out.append(("K17 | config 1", k17, (),
                (x1.numel() * 4 + 2 * yr1.numel() * 4) / 3.35e12 * 1e3))

    # one config-4 chunk: K2, K3 (f32, bf16), K7 (f32, bf16)
    n4 = 1 << 22
    centers = [0.11 + 0.37 * c / C4 for c in range(C4)]
    words = np.asarray([freq_to_word(-f) for f in centers], np.uint32)
    taps4 = lowpass(64, 0.03)
    g4r, g4i, deltas = (torch.as_tensor(a, device=dev) for a in kct.ctaps_host(taps4, words, 4))
    t4 = torch.as_tensor(taps4, device=dev)
    w04 = torch.as_tensor(((-hist * words.astype(np.int64)) % (1 << 32)).astype(np.uint32)
                          .view(np.int32), device=dev)
    dw4 = torch.as_tensor(words.view(np.int32), device=dev)
    nt4 = n4 // (OUT_TILE * 4)
    x4 = torch.randn((C4, 2, hist + n4), device=dev, generator=gen)
    d4 = torch.empty((C4, nt4, OUT_TILE), device=dev)
    st4 = torch.empty((C4, nt4, 128), device=dev)
    stride4, span4 = OUT_TILE * 4, OUT_TILE * 4 + hist
    bound_out = (d4.numel() + st4.numel()) * 4

    def k2(lib):
        check(lib.srcdsp_fsk_fused(x4.data_ptr(), w04.data_ptr(), dw4.data_ptr(), t4.data_ptr(),
                                   d4.data_ptr(), st4.data_ptr(), C4, x4.shape[-1], nt4,
                                   OUT_TILE, 4, 64, hist, SPS, 1, _build.stream_handle(x4)), "K2")
        return (d4,)

    out.append(("K2 | config 4 chunk", k2, (st4,),
                (x4.numel() * 4 + bound_out) / 3.35e12 * 1e3))
    for dt, sfx in ((torch.float32, ""), (torch.bfloat16, " bf16")):
        xin = x4.to(dt)
        fr = kpf.frame_planes(xin, stride4, span4)
        xr_f, xi_f = fr[:, 0].contiguous(), fr[:, 1].contiguous()
        del fr
        b16 = int(dt == torch.bfloat16)

        def k3(lib, xin=xin, b16=b16, label="K3" + sfx):
            check(lib.srcdsp_fsk_ctaps(xin.data_ptr(), g4r.data_ptr(), g4i.data_ptr(),
                                       deltas.data_ptr(), d4.data_ptr(), st4.data_ptr(), C4,
                                       xin.shape[-1], nt4, OUT_TILE, 4, 64, hist, SPS, 1, b16,
                                       _build.stream_handle(xin)), label)
            return (d4,)

        def k7(lib, xr_f=xr_f, xi_f=xi_f, b16=b16, label="K7" + sfx):
            check(lib.srcdsp_fsk_preframed(xr_f.data_ptr(), xi_f.data_ptr(), g4r.data_ptr(),
                                           g4i.data_ptr(), deltas.data_ptr(), d4.data_ptr(),
                                           st4.data_ptr(), C4, nt4, span4, OUT_TILE, 4, 64,
                                           hist, SPS, 1, b16, _build.stream_handle(xr_f)), label)
            return (d4,)

        esz = xin.element_size()
        out.append(("K3" + sfx + " | config 4 chunk", k3, (st4,),
                    (xin.numel() * esz + bound_out) / 3.35e12 * 1e3))
        out.append(("K7" + sfx + " | config 4 chunk", k7, (st4,),
                    (2 * xr_f.numel() * esz + bound_out) / 3.35e12 * 1e3))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_ctaps: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(variants())
    dev = torch.device("cuda", 0)
    fns, bounds, all_equal = {}, {}, True
    for label, launch, extra, bound in cases(dev):
        ref = [t.clone() for t in launch(libs["before"])]
        ref_extra = [t.clone() for t in extra]
        for name, lib in libs.items():
            got = launch(lib)
            torch.cuda.synchronize()
            if name not in ABLATIONS and name != "before":
                equal = all(torch.equal(a, b) for a, b in zip(got, ref))
                all_equal &= equal
                st_diff = max((float((a - b).abs().max()) for a, b in zip(extra, ref_extra)),
                              default=None)
                print(f"{label}: {name} == before (torch.equal): {equal}"
                      + ("" if st_diff is None else f"; st max |diff| {st_diff:.3e}"))
            fns[f"{name} | {label}"] = lambda lib=lib, launch=launch: launch(lib)
            bounds[f"{name} | {label}"] = bound
        del ref, ref_extra
    times = turns(fns, args.turns, 5)
    print(f"{args.turns} turns of 5 launches back to back; every variant but the ablations == "
          f"before: {all_equal}")
    for k, v in times.items():
        m = float(np.median(v))
        b = bounds[k]
        print(f"{k:36s} median {m:.4f} ms (min {min(v):.4f}, max {max(v):.4f}); bound {b:.4f} "
              f"ms, {b / m:.3f} of it")
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
