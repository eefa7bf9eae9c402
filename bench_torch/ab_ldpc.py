#!/usr/bin/env python3
"""A/B of the LDPC kernels K14 (edge-form) and K15 (QC layered), both in
srcdsp_tpu_torch/csrc/ldpc.cu, against their earlier bodies and against
variants of themselves, on one card.

    PYTHONPATH=. python bench_torch/ab_ldpc.py [--turns 10]

Builds, from the checkout's sources, one library of ldpc.cu per source
variant into build/ab_ldpc/<variant>/ (nvcc with the port's flags, all
started together):

- ``before``: the earlier bodies (bench_torch/ab_ldpc_before/): K14 one
  codeword a block with both message arrays and both index tables in shared
  memory, K15 4 codewords a block with every message in shared memory;
- ``kernel``: ldpc.cu as it is;
- ``kernel_geos``: ldpc.cu with K14 at the geometries the wrapper never
  picks as well (codewords a block and a thread 2/1, 4/1, 4/2, 8/2);
- ``kernel_regs``: K15 with its check state in registers as well
  (bench_torch/ab_ldpc_regs/, built only here);
- ``kernel_unroll2``: K15's edge loops unrolled by two;

and ablations of ``before``, which compute something else and are only
timed: ``before_ctab`` (K15's layer tables and K14's index tables not read
from device memory: K15's from constant memory, K14's made from the slot
index), ``before_cw4`` (K15's codewords a block as the constant 4, which the
phase-3 code has: the same bits) and ``before_nosync`` (K14 without its two
barriers an iteration); and of ``kernel``: ``kernel_noiter`` (no iteration:
staging and the stores alone), ``kernel_nosync`` (no barrier) and
``kernel_pass1`` (K15's first pass over a layer's rows alone; K14 as is,
since its first pass alone would be dead code).

The new bodies run at several geometries from one library (codewords a
block ``cw`` and a thread ``cpt``; K15's check state in registers
(``regs``), shared memory (``smem``) or device memory (``gstate``)). Every
variant but the ablations must give ``before``'s posteriors bit for bit;
it prints torch.equal for each, and ``kernel`` at the wrapper's geometry
against the plain ldpc_decode_edges_ref / qc_decode_layered_ref. Cases: K14
at [504, 1024] (10 iterations) and K15 at [1536, 4096] and [1536, 199] (6
iterations), the LLRs of configs.build_ldpc. Times each in turns (forward, then backward),
each turn 5 launches back to back between CUDA events, and each at one call
(median of 5). Prints the card's name and power limit first, then each
library's registers and spills as ptxas reports them, the opcode counts of
each SASS loop of the wrapper's K14 and K15 instantiations in ``kernel``
and the SM clock while timing; exits 1 where a variant's bits differ.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "bench_torch"))

from ab_bcjr import loop_opcodes, turns  # noqa: E402
from srcdsp_tpu_torch.configs import build_ldpc  # noqa: E402
from srcdsp_tpu_torch.kernels import _build  # noqa: E402
from srcdsp_tpu_torch.kernels import ldpc_pallas as kl  # noqa: E402

CSRC = REPO / "srcdsp_tpu_torch" / "csrc"
BEFORE = REPO / "bench_torch" / "ab_ldpc_before"
REGS = REPO / "bench_torch" / "ab_ldpc_regs"
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
OLD_SIGNATURES = {"srcdsp_ldpc_edges": [_P] * 4 + [_I] * 7 + [_F, _P],
                  "srcdsp_ldpc_qc": [_P] * 5 + [_I] * 7 + [_F, _P]}
CTAB = [
    ("__device__ __forceinline__ float kInf()",
     "__constant__ int32_t c_tab[3 * 1024];\n\n__device__ __forceinline__ float kInf()"),
    ("const int s0 = starts[l], s1 = starts[l + 1];",
     "const int s0 = c_tab[l], s1 = c_tab[l + 1];"),
    ("const int rr = r + shifts[e];\n          const int col = cols[e] * z",
     "const int rr = r + c_tab[2048 + e];\n          const int col = c_tab[1024 + e] * z"),
    ("const int rr = r + shifts[e];\n          const int col = cols[e] * z",
     "const int rr = r + c_tab[2048 + e];\n          const int col = c_tab[1024 + e] * z"),
    ("  const size_t smem = (size_t)(nb + n_blocks) * z * cw * sizeof(float);",
     "  cudaMemcpyToSymbolAsync(c_tab, starts, (n_layers + 1) * 4, 0, cudaMemcpyDeviceToDevice,\n"
     "                          (cudaStream_t)stream);\n"
     "  cudaMemcpyToSymbolAsync(c_tab, cols, n_blocks * 4, 4096, cudaMemcpyDeviceToDevice,\n"
     "                          (cudaStream_t)stream);\n"
     "  cudaMemcpyToSymbolAsync(c_tab, shifts, n_blocks * 4, 8192, cudaMemcpyDeviceToDevice,\n"
     "                          (cudaStream_t)stream);\n"
     "  const size_t smem = (size_t)(nb + n_blocks) * z * cw * sizeof(float);"),
    ("    rs[e] = row_src[e];", "    rs[e] = e % e_col;"),
    ("for (int e = threadIdx.x; e < e_col; e += blockDim.x) cs[e] = col_src[e];",
     "for (int e = threadIdx.x; e < e_col; e += blockDim.x) cs[e] = e % e_row;"),
]
# variant: [(old, new)] in the before body
SUBS = {
    "before_ctab": CTAB,
    "before_cw4": [("const int b = t % cw, r = t / cw;", "const int b = t % 4, r = t / 4;")],
    "kernel_geos": [("  SRCDSP_EDGES(8, 4)\n", "  SRCDSP_EDGES(8, 4)\n  SRCDSP_EDGES(2, 1)\n"
                     "  SRCDSP_EDGES(4, 1)\n  SRCDSP_EDGES(4, 2)\n  SRCDSP_EDGES(8, 2)\n")],
    "kernel_unroll2": [("          for (int d = c0; d < c1; ++d) {\n            float pn[CPT];",
                        "#pragma unroll 2\n          for (int d = c0; d < c1; ++d) {\n"
                        "            float pn[CPT];"),
                       ("          for (int d = c0; d < c1; ++d) {\n            float* pq",
                        "#pragma unroll 2\n          for (int d = c0; d < c1; ++d) {\n"
                        "            float* pq")],
    "kernel_noiter": [("  for (int it = 0; it < iters; ++it) {\n    for (int l = 0;",
                       "  for (int it = 0; it < 0; ++it) {\n    for (int l = 0;"),
                      ("if (it == iters)", "if (it == 0)")],
    "kernel_nosync": [("      __syncthreads();\n    }\n  }\n  tile_out(post, ps, n, cw_log2,",
                       "    }\n  }\n  tile_out(post, ps, n, cw_log2,"),
                      ("      st(ps + o, p);\n    }\n    __syncthreads();\n"
                       "    if (it == iters) break;",
                       "      st(ps + o, p);\n    }\n    if (it == iters) break;"),
                      ("        st(rc + e.y * CW + g * CPT, c);\n      }\n    }\n"
                       "    __syncthreads();",
                       "        st(rc + e.y * CW + g * CPT, c);\n      }\n    }")],
    "kernel_pass1": [("        for (int c0 = 0, c = 0; c0 < deg; c0 += kChunk, ++c) {\n"
                      "          const int c1 = min(deg, c0 + kChunk);\n"
                      "          uint32_t nsg[CPT];",
                      "        for (int c0 = 0, c = 0; c0 < 0; c0 += kChunk, ++c) {\n"
                      "          const int c1 = min(deg, c0 + kChunk);\n"
                      "          uint32_t nsg[CPT];")],
    "before_nosync": [("      }\n    }\n    __syncthreads();\n    // check phase",
                       "      }\n    }\n    // check phase"),
                      ("        R[e] = c;\n      }\n    }\n    __syncthreads();",
                       "        R[e] = c;\n      }\n    }")],
}
ABLATIONS = ("before_ctab", "before_nosync", "kernel_noiter", "kernel_nosync", "kernel_pass1")
EDGE_GEOS = ((1, 1), (2, 2), (4, 4), (8, 4))  # (cw, cpt) built in ldpc.cu
EDGE_GEOS_MORE = ((2, 1), (4, 1), (4, 2), (8, 2))  # built in kernel_geos
QC_GEOS = ((2, 1, "shared"), (2, 2, "shared"), (4, 2, "shared"), (4, 4, "shared"),
           (8, 1, "shared"), (8, 2, "shared"), (8, 4, "shared"), (16, 4, "shared"),
           (8, 1, "device"), (2, 1, "registers"), (2, 2, "registers"), (8, 2, "registers"),
           (8, 4, "registers"))  # (cw, cpt, where the check state lives)
STATES = ("shared", "device", "registers")  # srcdsp_ldpc_qc's state argument
STATE_LABELS = {"registers": "regs", "shared": "smem", "device": "gstate"}


def _qc_geos(name: str) -> list:
    """The K15 geometries a library runs: the state in registers only where
    built (kernel_regs), the ablations and the unrolled loops at the
    wrapper's geometry only."""
    if name in ABLATIONS or name == "kernel_unroll2":
        return [(8, 4, "shared")]
    if name == "kernel_geos":  # K15 as in kernel
        return []
    return [g for g in QC_GEOS if (g[2] == "registers") == (name == "kernel_regs")]


def _sub(text: str, old: str, new: str, where: str) -> str:
    if old not in text:
        raise SystemExit(f"ab_ldpc: {old!r} not in {where}; update the variant")
    return text.replace(old, new, 1)


def variants() -> dict[str, str]:
    """{variant: ldpc.cu source text}."""
    before = (BEFORE / "ldpc.cu").read_text()
    out = {"before": before, "kernel": (CSRC / "ldpc.cu").read_text(),
           "kernel_regs": (REGS / "ldpc.cu").read_text()}
    for name, subs in SUBS.items():
        text = before if name.startswith("before") else out["kernel"]
        for old, new in subs:
            text = _sub(text, old, new, name)
        out[name] = text
    return out


def build(sources: dict[str, str]) -> dict[str, ctypes.CDLL]:
    root = REPO / "build" / "ab_ldpc"
    procs = {}
    for name, text in sources.items():
        d = root / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "ldpc.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(d / "ldpc.o"),
             str(d / "ldpc.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, p in procs.items():
        logs[name] = p.communicate()[0]
        (root / name / "nvcc.log").write_text(logs[name])
        if p.returncode:
            raise SystemExit(f"ab_ldpc: nvcc failed on {name}:\n{logs[name]}")
    libs = {}
    for name in sources:
        d = root / name
        subprocess.run([_build._nvcc(), "-shared", "-o", str(d / "lib.so"), str(d / "ldpc.o")],
                       check=True)
        for kern, (regs, st, ld) in _build.ptxas_report(logs[name]).items():
            print(f"{name}: {kern}: {regs} registers, {st} bytes spill stores, {ld} bytes spill "
                  f"loads")
        lib = ctypes.CDLL(str(d / "lib.so"))
        sigs = OLD_SIGNATURES if name.startswith("before") else _build._SIGNATURES
        for fn in ("srcdsp_ldpc_edges", "srcdsp_ldpc_qc"):
            getattr(lib, fn).argtypes = sigs[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _check(rc: int, name: str) -> None:
    if rc:
        raise SystemExit(f"ab_ldpc: {name} failed with cudaError_t {rc}")


def edges_launchers(libs, plan, llr, iters) -> dict:
    """{label: launch} of K14 on llr [n, B] for every library and geometry."""
    p, b = plan, llr.shape[1]
    post = torch.empty_like(llr)
    stream = _build.stream_handle(llr)
    rs, cs = (torch.as_tensor(a, device=llr.device) for a in (p.row_src, p.col_src))
    row_edges = torch.as_tensor(kl._row_edges(p), device=llr.device)
    out = {}
    for name, lib in libs.items():
        if name.startswith("before"):
            def launch(lib=lib, name=name):
                _check(lib.srcdsp_ldpc_edges(llr.data_ptr(), rs.data_ptr(), cs.data_ptr(),
                                             post.data_ptr(), p.n, p.n_pad, p.m_pad, p.dv, p.dc,
                                             b, iters, 0.8125, stream), name)
                return post
            out[name] = launch
            continue
        if name in ("kernel_regs", "kernel_pass1", "kernel_unroll2"):  # K14 as in kernel
            continue
        geos = ((8, 4),) if name in ABLATIONS else EDGE_GEOS_MORE if name == "kernel_geos" \
            else EDGE_GEOS
        for cw, cpt in geos:
            threads = min(1024, kl._round_up(p.m * (cw // cpt), 32))

            def launch(lib=lib, cw=cw, cpt=cpt, threads=threads, name=name):
                _check(lib.srcdsp_ldpc_edges(llr.data_ptr(), row_edges.data_ptr(),
                                             post.data_ptr(), p.n, p.n_pad, p.m, p.m_pad, p.dv,
                                             p.dc, b, iters, 0.8125, cw, cpt, threads, stream),
                       name)
                return post
            out[f"{name} cw{cw} cpt{cpt}"] = launch
    return out


def qc_launchers(libs, plan, llr, iters) -> dict:
    """{label: launch} of K15 on llr [n, B] for every library and geometry."""
    n, b = llr.shape
    post = torch.empty_like(llr)
    stream = _build.stream_handle(llr)
    starts = np.cumsum([0] + [len(c) for c, _ in plan.layers]).astype(np.int32)
    cols = np.asarray([j for c, _ in plan.layers for j in c], np.int32)
    shifts = np.asarray([s for _, sh in plan.layers for s in sh], np.int32)
    tabs = [torch.as_tensor(a, device=llr.device) for a in (starts, cols, shifts)]
    ptrs = [t.data_ptr() for t in tabs]
    geo = kl.qc_geometry(plan)
    n_layers, z = len(plan.layers), plan.z
    ps, state = n * 4, n_layers * z * (2 + geo.words) * 4
    tables = plan.n_blocks * 8 + (n_layers + 1) * 4
    gstate = torch.empty(((b + 16) * n_layers * z * (2 + geo.words),), device=llr.device)
    out = {}
    for name, lib in libs.items():
        if name.startswith("before"):
            def launch(lib=lib, name=name):
                _check(lib.srcdsp_ldpc_qc(llr.data_ptr(), *ptrs, post.data_ptr(), n_layers, z,
                                          plan.nb, plan.n_blocks, b, iters, 4, 0.8125, stream),
                       name)
                return post
            out[name] = launch
            continue
        for cw, cpt, where in _qc_geos(name):
            smem = cw * (ps + (state if where == "shared" else 0)) + tables
            threads = min(1024, kl._round_up(z * (cw // cpt), 32))

            def launch(lib=lib, cw=cw, cpt=cpt, where=where, smem=smem, threads=threads,
                       name=name):
                _check(lib.srcdsp_ldpc_qc(llr.data_ptr(), *ptrs, post.data_ptr(),
                                          gstate.data_ptr() if where == "device" else None,
                                          n_layers, z, plan.nb, plan.n_blocks, geo.words, b,
                                          iters, cw.bit_length() - 1, cpt,
                                          STATES.index(where), 0.8125, threads, smem,
                                          stream), name)
                return post
            out[f"{name} cw{cw} cpt{cpt} {STATE_LABELS[where]}"] = launch
    return out


def one_call_ms(fn, reps: int = 5) -> float:
    """Median of `reps` single calls, each between CUDA events after a sync."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return float(np.median(out))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ab_ldpc: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    libs = build(variants())
    dev = torch.device("cuda", 0)
    led = build_ldpc("edges", 1024, device=dev)
    lqc = build_ldpc("qc", 4096, device=dev)
    ep, qp = led.meta["plan"], lqc.meta["plan"]
    llr15 = lqc.example[0].T.contiguous()
    cases = (("K14 [504, 1024] x10", led.example[0].T.contiguous(), 10, edges_launchers,
              lambda x, it: kl.ldpc_decode_edges_ref(ep, x, it), ep),
             ("K15 [1536, 4096] x6", llr15, 6, qc_launchers,
              lambda x, it: kl.qc_decode_layered_ref(qp, x, it), qp),
             ("K15 [1536, 199] x6", llr15[:, :199].contiguous(), 6, qc_launchers,
              lambda x, it: kl.qc_decode_layered_ref(qp, x, it), qp))
    fns, all_equal = {}, True
    for label, llr, iters, make, plain, plan in cases:
        launches = make(libs, plan, llr, iters)
        ref = launches["before"]().clone()
        torch.cuda.synchronize()
        wrapper = (kl.make_ldpc_kernel(plan, iters=iters, b_tile=1, device=dev) if "K14" in label
                   else kl.make_qc_kernel(plan, iters=iters, b_tile=1, device=dev))
        same = bool(torch.equal(wrapper(llr), plain(llr, iters)))
        all_equal &= same
        print(f"{label}: kernel (wrapper geometry) == plain (torch.equal): {same}")
        for name, launch in launches.items():
            got = launch()
            torch.cuda.synchronize()
            if name.split()[0] not in ABLATIONS and name != "before":
                equal = bool(torch.equal(got, ref))
                all_equal &= equal
                print(f"{label}: {name} == before (torch.equal): {equal}")
            fns[f"{name} | {label}"] = launch
        fns[f"wrapper | {label}"] = lambda w=wrapper, x=llr: w(x)
    obj = REPO / "build" / "ab_ldpc" / "kernel" / "ldpc.o"
    eg, qg = kl.edges_geometry(ep), kl.qc_geometry(qp, 4096)
    for kern in _build.ptxas_report((obj.parent / "nvcc.log").read_text()):
        if (f"ldpc_edges_kernelILi{eg.cw}ELi{eg.cpt}E" in kern
                or f"ldpc_qc_kernelILi{qg.cpt}E" in kern):
            for n, (count, ops) in enumerate(loop_opcodes(obj, kern)):
                print(f"kernel {kern[-40:]} SASS loop {n}: {count} instructions {ops}")
    clocks = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader",
                               "-lms", "100"], stdout=subprocess.PIPE, text=True)
    times = turns(fns, args.turns, 5)
    single = {k: one_call_ms(fn) for k, fn in fns.items()}
    clocks.terminate()
    mhz = [int(v.split()[0]) for v in clocks.communicate()[0].split("\n") if v.strip()]
    print(f"SM clock while timing: median {np.median(mhz):.0f} MHz over {len(mhz)} samples "
          f"(min {min(mhz)}, max {max(mhz)})" if mhz else "SM clock: not read")
    print(f"{args.turns} turns of 5 launches back to back, and one call (median of 5); every "
          f"variant but the ablations == before: {all_equal}")
    for k, v in times.items():
        print(f"{k:52s} b2b median {float(np.median(v)):.4f} ms (min {min(v):.4f}, max "
              f"{max(v):.4f}); one call {single[k]:.4f}")
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
