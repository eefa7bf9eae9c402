#!/usr/bin/env python3
"""A/B of the max-log BCJR kernel K16 (srcdsp_tpu_torch/csrc/bcjr.cu) against
its one-state-a-lane body and against variants of itself, on one card.

    PYTHONPATH=. python bench_torch/ab_bcjr.py [--turns 10]

Builds, from the checkout's sources, one library of bcjr.cu per variant into
build/ab_bcjr/<variant>/ (nvcc with the port's flags, all started together):

- ``before``: the one-state-a-lane body (bench_torch/ab_bcjr_before/: 8
  lanes a codeword, 4 codewords a warp, states exchanged by __shfl_sync,
  the backward pass then the forward one, 2t steps on the chain);
- ``kernel``: bcjr.cu as it is (one codeword a thread; warp 0 runs the
  forward recursion and warp 1 the backward one at once, then the block's
  32 warps write the posteriors; ls and lp staged in shared memory; loads
  kQueue = 1 step ahead);
- ``meet``: the two recursion warps meet in the middle and write the
  posteriors of their second halves themselves (bench_torch/ab_bcjr_meet/,
  built only here);
- ``lanes2``: ``meet`` with two lanes a codeword, 4 states each, one round
  of shuffles a step, ls and lp from device memory
  (bench_torch/ab_bcjr_lanes2/, built only here);
- ``w8``, ``w16``: blocks of 8 or 16 warps, not 32;
- ``q2``, ``q4``: loads 2 or 4 steps ahead;
- ``nostage``: ls and lp read from device memory, not staged;
- ``ffma``: gamma as one fmaf(+-1, 0.5*lp, 0.5*ls) a state (exact, as the
  sign is +-1) instead of two adds and a select;

and ablations, which compute something else and are only timed:
``before_noload`` (``before`` with ls, lp and the beta history read from
registers, not memory), ``before_noshfl`` (``before`` with every shuffle
replaced by the lane's own register, a static gather), ``nopost``
(``kernel`` without the posteriors: staging and the two recursions) and
``norec`` (``kernel`` without the recursions: staging and the posteriors).

Every variant but the ablations must give ``before``'s posteriors bit for
bit; it prints torch.equal for each, and ``kernel`` against
bcjr_decode_batch. Cases: the turbo's first half, [515, 256] terminated
(phase 3's row), its second half, [512, 256] open, and [515, 10]
terminated (one block, 22 idle lanes). Times each in turns (forward, then
backward), each turn 5 launches back to back between CUDA events. Prints
the card's name and power limit first, then each variant's registers and
spills as ptxas reports them, the opcode counts of each SASS loop of
``kernel`` (cuobjdump) and the SM clock that nvidia-smi reads while timing.
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
from srcdsp_tpu_torch.kernels import bcjr_pallas as kb  # noqa: E402
from srcdsp_tpu_torch.turbo import bcjr_decode_batch, make_rsc  # noqa: E402

CSRC = REPO / "srcdsp_tpu_torch" / "csrc"
BEFORE = REPO / "bench_torch" / "ab_bcjr_before"
MEET = REPO / "bench_torch" / "ab_bcjr_meet"
LANES2 = REPO / "bench_torch" / "ab_bcjr_lanes2"
QUEUE = "constexpr int kQueue = 1;"
WARPS = "constexpr int kWarps = 32;"
OLD_LOADS = [("const float bt = live ? betas[i * 8 + s] : 0.f;", "const float bt = alpha_n;"),
             ("const float l_s = live ? ls[i] : 0.f, l_p = live ? lp[i] : 0.f;",
              "const float l_s = (float)(u & 15), l_p = (float)(u & 7);")]
FFMA = [("  uint32_t p[8];\n};", "  uint32_t p[8];\n  float sg[8];\n};"),
        ("  const float gp = __fadd_rn(hs, hp), gm = __fadd_rn(hs, -hp);\n#pragma unroll\n"
         "  for (int s = 0; s < 8; ++s) gr[s] = sel(m.p[s], gm, gp);",
         "#pragma unroll\n  for (int s = 0; s < 8; ++s) gr[s] = fmaf(m.sg[s], hp, hs);"),
        ("  for (int s = 0; s < 8; ++s) m.p[s] = (par_mask >> s) & 1 ? ~0u : 0u;",
         "  for (int s = 0; s < 8; ++s) m.p[s] = (par_mask >> s) & 1 ? ~0u : 0u;\n"
         "  for (int s = 0; s < 8; ++s) m.sg[s] = (par_mask >> s) & 1 ? -1.f : 1.f;")]
# variant: [(old, new)] in bcjr.cu (the before body's for before_*)
SUBS = {
    "w8": [(WARPS, "constexpr int kWarps = 8;")],
    "w16": [(WARPS, "constexpr int kWarps = 16;")],
    "q2": [(QUEUE, "constexpr int kQueue = 2;")],
    "q4": [(QUEUE, "constexpr int kQueue = 4;")],
    "nostage": [("constexpr size_t kStageBytes = 200 * 1024;", "constexpr size_t kStageBytes = 0;")],
    "ffma": FFMA,
    "nopost": [("for (int u = warp; u < T; u += kWarps) {",
                "for (int u = warp + T; u < T; u += kWarps) {")],
    "norec": [("  if (warp < 2) {", "  if (warp < 0) {")],
    "before_noload": OLD_LOADS,
    "before_noshfl": [(re.compile(r"__shfl_sync\(kFull, (\w+), \w+, 8\)"), r"\1"),
                      (re.compile(r"__shfl_xor_sync\(kFull, x, \d, 8\)"), "x")],
}
ABLATIONS = ("nopost", "norec", "before_noload", "before_noshfl")
CODE = make_rsc()
CASES = (("[515, 256] terminated", 515, 256, True), ("[512, 256] open", 512, 256, False),
         ("[515, 10] terminated", 515, 10, True))


def _sub(text: str, old, new: str, where: str) -> str:
    if isinstance(old, re.Pattern):
        if not old.search(text):
            raise SystemExit(f"ab_bcjr: {old.pattern!r} not in {where}; update the variant")
        return old.sub(new, text)
    if old not in text:
        raise SystemExit(f"ab_bcjr: {old!r} not in {where}; update the variant")
    return text.replace(old, new)


def variants() -> dict[str, str]:
    """{variant: bcjr.cu source text}."""
    kernel = (CSRC / "bcjr.cu").read_text()
    before = (BEFORE / "bcjr.cu").read_text()
    out = {"before": before, "kernel": kernel, "meet": (MEET / "bcjr.cu").read_text(),
           "lanes2": (LANES2 / "bcjr.cu").read_text()}
    for name, subs in SUBS.items():
        text = before if name.startswith("before") else kernel
        for old, new in subs:
            text = _sub(text, old, new, name)
        out[name] = text
    return out


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    root = REPO / "build" / "ab_bcjr"
    procs = {}
    for name, text in sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "bcjr.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-c", "-o", str(d / "bcjr.o"), str(d / "bcjr.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"ab_bcjr: nvcc failed on {name}:\n{logs[name]}")
    libs = {}
    for name in sources:
        d = root / name
        subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"), str(d / "bcjr.o")],
                       check=True)
        for kern, (regs, st, ld) in _build.ptxas_report(logs[name]).items():
            print(f"{name}: {kern}: {regs} registers, {st} bytes spill stores, {ld} bytes spill "
                  f"loads")
        for line in logs[name].splitlines():
            if "stack frame" in line:
                print(f"{name}: ptxas {line.strip()}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        lib.srcdsp_bcjr.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(name: str, lib: ctypes.CDLL, ls, lp, terminated: bool):
    """A launch of variant `name` on [t, B] inputs -> post [t, B] (the before
    body takes the trellis tables by pointer and a [t, B, 8] history)."""
    t, b = ls.shape
    post = torch.empty_like(ls)
    hist = torch.empty((2, t, 8, -(-b // 32) * 32), device=ls.device)  # the most any takes
    stream = _build.stream_handle(ls)
    if name.startswith("before"):
        tables = np.concatenate([CODE.next_state[:, 0], CODE.next_state[:, 1],
                                 CODE.prev_state[:, 0], CODE.prev_state[:, 1]]).astype(np.int32)
        sg = (1 - 2 * CODE.parity[:, 0]).astype(np.float32)
        lib.srcdsp_bcjr.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p] * 3
        extra = (tables.ctypes.data, sg.ctypes.data)
    else:
        lib.srcdsp_bcjr.argtypes = _build._SIGNATURES["srcdsp_bcjr"]
        extra = kb.trellis_masks(CODE)

    def launch():
        rc = lib.srcdsp_bcjr(ls.data_ptr(), lp.data_ptr(), post.data_ptr(), hist.data_ptr(), t, b,
                             int(terminated), *extra, stream)
        if rc:
            raise SystemExit(f"ab_bcjr: {name} failed with cudaError_t {rc}")
        return post

    return launch


def loop_opcodes(obj: Path, fn: str | None = None) -> list[tuple[int, dict]]:
    """The SASS loops of an object file (cuobjdump -sass, beside nvcc), of
    its kernel `fn` (a mangled name) only where given: for each backward
    branch, the body's instruction count and opcode counts."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", *(["-fun", fn] if fn else []), str(obj)],
                          capture_output=True, text=True).stdout
    ins = [(int(m.group(1), 16), m.group(2)) for m in
           re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", text)]
    out = []
    for addr, txt in ins:
        m = re.search(r"BRA\s+(?:`\(\.L_x_\d+\)|0x([0-9a-f]+))", txt)
        if m and m.group(1) and int(m.group(1), 16) < addr:
            ops: dict[str, int] = {}
            for a, t in ins:
                if int(m.group(1), 16) <= a <= addr:
                    op = re.sub(r"^@!?U?P\w+\s+", "", t).split()[0].split(".")[0]
                    ops[op] = ops.get(op, 0) + 1
            out.append((sum(ops.values()), dict(sorted(ops.items(), key=lambda kv: -kv[1]))))
    return out


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
        print("ab_bcjr: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(variants())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    fns, all_equal = {}, True
    for label, t, b, terminated in CASES:
        ls, lp = (4.0 * torch.randn((t, b), device=dev, generator=gen) for _ in range(2))
        launches = {name: launcher(name, lib, ls, lp, terminated) for name, lib in libs.items()}
        ref = launches["before"]().clone()
        plain = bcjr_decode_batch(CODE, ls, lp, terminated=terminated)[0]
        same = bool(torch.equal(launches["kernel"](), plain))
        all_equal &= same
        print(f"{label}: kernel == bcjr_decode_batch (torch.equal): {same}")
        for name, launch in launches.items():
            got = launch()
            torch.cuda.synchronize()
            if name not in ABLATIONS and name != "before":
                equal = bool(torch.equal(got, ref))
                all_equal &= equal
                print(f"{label}: {name} == before (torch.equal): {equal}")
            fns[f"{name} | {label}"] = launch
    for n, (count, ops) in enumerate(loop_opcodes(REPO / "build" / "ab_bcjr" / "kernel" /
                                                  "bcjr.o")):
        print(f"kernel SASS loop {n}: {count} instructions {ops}")
    clocks = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader",
                               "-lms", "100"], stdout=subprocess.PIPE, text=True)
    times = turns(fns, args.turns, 5)
    clocks.terminate()
    mhz = [int(v.split()[0]) for v in clocks.communicate()[0].split("\n") if v.strip()]
    print(f"SM clock while timing: median {np.median(mhz):.0f} MHz over {len(mhz)} samples "
          f"(min {min(mhz)}, max {max(mhz)})" if mhz else "SM clock: not read")
    print(f"{args.turns} turns of 5 launches back to back; every variant but the ablations == "
          f"before: {all_equal}")
    for k, v in times.items():
        print(f"{k:45s} median {float(np.median(v)):.4f} ms (min {min(v):.4f}, max {max(v):.4f})")
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
