"""Fused NCO-mix + FIR + decimate, kernel K1 (counterpart of
``srcdsp_tpu/kernels/mixfir.py``).

Each input sample is read once, mixed by its exact u32 phase word
``word0 + g*dword`` (g = index into the history-prepended input), and
filtered + decimated in the same pass:

    y[J] = sum_a h[a] * u[J*M + hist - a],   J = row*OT + col

HK (``hist``) is taps-1 rounded up to 128; callers prepend HK history samples
(zeros at stream start), exactly as for the JAX kernel, so both packages take
the same arrays. Output planes are [C, NT, OT].

The CUDA kernel is ``csrc/mixfir.cu`` on the ring of ``csrc/fir_ring.cuh``:
a block owns a run of consecutive outputs of one channel, stages their window
mixed, and each thread computes R consecutive outputs from a register ring
per residue of the tap index mod decim. The ring's ownership and
shared-memory index map are mirrored here (`ring_shape`, `fir_*`, each citing
its line) and checked in numpy by ``tests/test_torch_mixfir.py``; the
complex-taps and FSK bodies use the same mirror with their shapes.
The words travel to the kernel by value (`host_words`), no copy to the
device. On a CPU tensor the wrappers run `mix_fir_plain`, the plain PyTorch
version beside it; on a CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.ops.fir import pin_f32
from srcdsp_tpu_torch.ops.nco import MASK32, TWO_PI, _INV_SCALE, word_tensor

LANE = 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def toeplitz_taps(taps: np.ndarray, decim: int, out_tile: int,
                  hist: int) -> np.ndarray:
    """H_T[a, j] = h[j*decim + hist - a], zero outside [0, T)."""
    h = np.asarray(taps, np.float32)
    t = h.shape[0]
    span = out_tile * decim + hist
    mat = np.zeros((span, out_tile), np.float32)
    for j in range(out_tile):
        for a in range(t):
            idx = j * decim + hist - a
            if 0 <= idx < span:
                mat[idx, j] = h[a]
    return mat


def banded_taps(taps: np.ndarray, decim: int, out_tile: int, hist: int,
                block_cols: int) -> np.ndarray:
    """Per-block bands of the Toeplitz matrix: [NB, BC*M + hist, BC]."""
    ht = toeplitz_taps(taps, decim, out_tile, hist)
    nb = out_tile // block_cols
    bspan = block_cols * decim + hist
    return np.stack([
        ht[j * block_cols * decim: j * block_cols * decim + bspan,
           j * block_cols: (j + 1) * block_cols]
        for j in range(nb)
    ])


def signed_phase_angle(words: torch.Tensor) -> torch.Tensor:
    """u32 words -> float32 radians, the word read as a signed turn: the
    JAX kernels' int32 phase math, ``float32(int32(word)) * (2*pi/2^32)``."""
    signed = words - ((words >> 31) << 32)
    return signed.to(torch.float32) * np.float32(TWO_PI * _INV_SCALE)


def check_planes(x: torch.Tensor, num_channels: int, hist: int, block: int,
                 in_dtype: torch.dtype = torch.float32) -> int:
    """Validate x [C, 2, hist + N] contiguous, of the kernel's input dtype;
    return N."""
    if x.dtype != in_dtype:
        raise ValueError(f"x dtype {x.dtype} != kernel in_dtype {in_dtype}")
    if x.ndim != 3 or x.shape[0] != num_channels or x.shape[1] != 2:
        raise ValueError(f"x must be [{num_channels}, 2, hist+N], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n = x.shape[-1] - hist
    if n <= 0 or n % block != 0:
        raise ValueError(f"N={n} not a multiple of kernel block {block}")
    return n


def check_in_dtype(in_dtype: torch.dtype) -> bool:
    """True for a bf16-ingest kernel, False for float32; anything else raises."""
    if in_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"in_dtype must be float32 or bfloat16, got {in_dtype}")
    return in_dtype == torch.bfloat16


def cuda_or_cpu(x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else raises."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {x.device}")


def check_f32_operand(x: torch.Tensor, device: torch.device, name: str) -> bool:
    """Validate a float32 operand of a kernel built for `device`; True for a
    CUDA tensor (launch the kernel), False for a CPU one (run the plain version)."""
    if x.dtype != torch.float32:
        raise ValueError(f"{name} dtype {x.dtype} != float32")
    if x.device != device:
        raise ValueError(f"{name} on {x.device}, kernel built for {device}")
    return cuda_or_cpu(x)


def fir_decim_rows(u: torch.Tensor, taps: torch.Tensor, decim: int, hist: int
                   ) -> torch.Tensor:
    """Plain FIR + decimate of history-prepended planes.

    u: [C, P, hist + N] f32; taps [T] (shared) or [C, T].
    Returns [C, P, N/decim] with y[J] = sum_a h[a] u[J*decim + hist - a].
    """
    pin_f32(u)
    c, p, _ = u.shape
    t = taps.shape[-1]
    v = u[..., hist - (t - 1):]                   # first output reads v[0 .. T-1]
    if taps.ndim == 1:
        y = F.conv1d(v.reshape(c * p, 1, -1), taps.flip(-1).reshape(1, 1, t), stride=decim)
    else:
        w = taps.flip(-1).repeat_interleave(p, dim=0).reshape(c * p, 1, t)
        y = F.conv1d(v.reshape(1, c * p, -1), w, stride=decim, groups=c * p)
    return y.reshape(c, p, -1)


def mix_planes(words0, dwords, x: torch.Tensor) -> torch.Tensor:
    """Planes x [C, 2, L] mixed sample by sample by the exact u32 word
    ``words0[c] + g*dwords[c]`` (g = index along L) -> [C, 2, L] float32."""
    _, _, length = x.shape
    g = torch.arange(length, dtype=torch.int64, device=x.device)
    w = (word_tensor(words0, x.device).reshape(-1, 1)
         + g * word_tensor(dwords, x.device).reshape(-1, 1)) & MASK32
    ang = signed_phase_angle(w)
    cs, sn = torch.cos(ang), torch.sin(ang)
    xr, xi = x[:, 0].to(torch.float32), x[:, 1].to(torch.float32)
    return torch.stack([xr * cs - xi * sn, xr * sn + xi * cs], dim=1)


def mix_fir_plain(words0, dwords, x: torch.Tensor, taps: torch.Tensor, decim: int,
                  out_tile: int, hist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: x [C, 2, hist+N], taps [T] or [C, T] -> yr, yi [C, NT, OT]."""
    c = x.shape[0]
    y = fir_decim_rows(mix_planes(words0, dwords, x), taps, decim, hist)
    return y[:, 0].reshape(c, -1, out_tile), y[:, 1].reshape(c, -1, out_tile)


def host_words(words, c: int) -> np.ndarray:
    """u32 words (an int, a sequence, a numpy array or a tensor; one word or
    C) as a host uint32 array [C], for the kernels that take their words by
    value. Words on a card cost a copy to the host and a wait for the card."""
    if isinstance(words, (int, np.integer)):
        return np.full(c, int(words) & MASK32, np.uint32)
    w = words.detach().cpu().numpy() if isinstance(words, torch.Tensor) else np.asarray(words)
    if w.dtype != np.uint32:
        w = (w.astype(np.int64) & MASK32).astype(np.uint32)
    return np.ascontiguousarray(np.broadcast_to(w.reshape(-1), (c,)))


def _mix_fir_cuda(words0, dwords, x: torch.Tensor, taps: torch.Tensor, decim: int,
                  out_tile: int, hist: int, counter: str
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load()
    c, _, length = x.shape
    nt = (length - hist) // (out_tile * decim)
    w0, dw = host_words(words0, c), host_words(dwords, c)
    yr = torch.empty((c, nt, out_tile), dtype=torch.float32, device=x.device)
    yi = torch.empty_like(yr)
    rc = lib.srcdsp_mixfir(x.data_ptr(), taps.data_ptr(), 0 if taps.ndim == 1 else taps.shape[-1],
                           yr.data_ptr(), yi.data_ptr(), w0.ctypes.data, dw.ctypes.data, c,
                           length, nt, out_tile, decim, taps.shape[-1], hist,
                           _build.stream_handle(x))
    _build.check(rc, counter)
    _build.LAUNCHES[counter] += 1
    return yr, yi


# The register ring's ownership and shared-memory index map (csrc/fir_ring.cuh,
# which K1 in csrc/mixfir.cu, and the complex-taps and FSK bodies, run),
# mirrored item by item (file:line of each). `shape` is K1's (fir_shape)
# unless given: mixfir_ctaps.ctaps_shape and fsk_fused.fsk_shape give the others.
class FirShape(NamedTuple):
    """fir_ring.cuh:46-55 RingShape."""

    r: int          # outputs a thread owns
    threads: int    # threads of a block
    outputs: int    # outputs a block owns
    chunk: int      # taps per chunk (zeros past T up to a whole chunk)
    log2s: int      # one float of padding after every 2^log2s window samples


def ring_shape(decim: int, r: int, threads: int) -> FirShape:
    """fir_ring.cuh:46-55: decimations 1, 2 and 4 have their own
    instantiation; any other runs the generic one, R = 1."""
    static = decim in (1, 2, 4)
    r = r if static else 1
    return FirShape(r, threads, threads * r, r * decim if static else 1,
                    (r * decim).bit_length() - 1 if static else 5)


def fir_shape(decim: int) -> FirShape:
    """fir_ring.cuh:58-59 FirShape, K1's (and K20's and K2's): R = 8 in blocks
    of 128 threads at decim 1 and 2, R = 4 in blocks of 256 at decim 4."""
    return ring_shape(decim, 4 if decim == 4 else 8, 256 if decim == 4 else 128)


def ctaps_shape(decim: int) -> FirShape:
    """fir_ring.cuh:62-63 CtapsShape (K4, K5, K17): K1's numbers, R = 8 in blocks
    of 128 threads at decim 1 and 2, R = 4 in blocks of 256 at decim 4."""
    return fir_shape(decim)


def fir_pad(i, log2s: int):
    """fir_ring.cuh:65 fir_pad (PaddedIndex in fsk_common.cuh): shared-memory
    index of window sample i, one float of padding after every 2^log2s."""
    return i + (i >> log2s)


def fir_geometry(decim: int, num_taps: int, hist: int, shape: FirShape | None = None,
                 pre: int = 0) -> tuple[int, int, int, int]:
    """fir_ring.cuh:80-92 ring_geometry: (tp taps padded with zeros to whole
    chunks, lead window samples before the block's hist-th, span window
    samples, plane floats of one padded plane); hist + lead is the least
    multiple of the padding stride that is at least hist, tp - 1 and
    num_taps - 1 + pre (pre = decim for the FSK bodies' predecessor)."""
    sh = shape or fir_shape(decim)
    tp = -(-num_taps // sh.chunk) * sh.chunk
    stride = 1 << sh.log2s
    lead = -(-max(tp - 1, hist, num_taps - 1 + pre) // stride) * stride - hist
    span = sh.outputs * decim + hist + lead
    return tp, lead, span, fir_pad(span - 1, sh.log2s) + 1


def fir_window_start(block: int, decim: int, lead: int, shape: FirShape | None = None) -> int:
    """mixfir.cu:80-84 (ctaps.cu:65-70): stream sample of window index 0 of
    `block` (the window is samples [start, start + span) of the
    history-prepended stream)."""
    return block * (shape or fir_shape(decim)).outputs * decim - lead


def fir_base(tid, decim: int, hist: int, lead: int, shape: FirShape | None = None):
    """mixfir.cu:88 (ctaps.cu:74, fsk.cu:151): window index that output 0 of
    thread `tid` reads at tap 0; output k reads base + k*decim - a at tap a."""
    return tid * (shape or fir_shape(decim)).r * decim + hist + lead


def fir_ring_index(base, p: int, rho: int, decim: int):
    """fir_ring.cuh:144-148 and :163-168: window index of ring position p of
    residue rho (p = 1 .. R-1 before the first chunk; p = -b entering at
    group b, the taps b*decim + rho)."""
    return base + p * decim - rho


def fir_ring_address(base, a0: int, q: int, decim: int, shape: FirShape | None = None,
                     offset: int = 0):
    """fir_ring.cuh:151 and :166: the padded address the ring loads tap
    a0 + q's entering sample from: fir_pad(base - O - a0 - S) + (S + O - q)
    + (q <= O), S = R*decim, O = `offset` (one fir_pad per chunk; base - O
    and a0 are multiples of S)."""
    sh = shape or fir_shape(decim)
    s = sh.r * decim
    return fir_pad(base - offset - a0 - s, sh.log2s) + (s + offset - q) + (q <= offset)


def fir_slot(p: int, r: int) -> int:
    """fir_ring.cuh:165 and :171: the ring register of position p, p mod R (the
    chunk loop starts every R groups, so the slot is static in the unrolled body)."""
    return p % r


def fir_output(block: int, tid, k: int, decim: int, shape: FirShape | None = None):
    """mixfir.cu:80, :89 (ctaps.cu:65, :75): output (per channel, row-major
    over [NT, OT]) of output k of thread `tid` in `block`; one past NT*OT is
    not stored."""
    sh = shape or fir_shape(decim)
    return block * sh.outputs + tid * sh.r + k


def ring_schedule(decim: int, num_taps: int, hist: int, shape: FirShape | None = None,
                  pre: int = 0, base=None, tp: int | None = None, offset: int = 0
                  ) -> tuple[np.ndarray, list]:
    """The ring's loads for every thread of a block, in the order the body
    issues them (fir_ring.cuh:141-183; the D = 0 chain :97-118): returns
    reads [threads, R, tp], the window index each FMA of output k at tap a
    reads (-1 where the generic body has no such FMA), and the list of load
    instructions, each the window indices of all threads. `base` (the
    threads' window indices of output 0 at tap 0, `offset` past multiples of
    R*decim) and `tp` (taps run, whole chunks) replace K1's where another
    body runs the ring (the resampler's classes, kernels/resample_pallas.py)."""
    sh = shape or fir_shape(decim)
    r = sh.r
    if base is None:
        tp, lead, _, _ = fir_geometry(decim, num_taps, hist, sh, pre)
        base = fir_base(np.arange(sh.threads), decim, hist, lead, sh)
    base = np.asarray(base)
    reads = np.full((base.shape[0], r, tp), -1)
    loads = []
    if decim not in (1, 2, 4):
        for a in range(num_taps):
            loads.append(base - a)
            reads[:, 0, a] = base - a
        return reads, loads
    ring = {}
    for rho in range(decim):
        for p in range(1, r):
            loads.append(fir_ring_index(base, p, rho, decim))
            ring[rho, fir_slot(p, r)] = loads[-1]
    for a0 in range(0, tp, sh.chunk):
        for u in range(r):
            for rho in range(decim):
                a = a0 + u * decim + rho
                b = a // decim
                loads.append(fir_ring_index(base, -b, rho, decim))
                if not np.array_equal(fir_ring_address(base, a0, u * decim + rho, decim, sh,
                                                       offset),
                                      fir_pad(loads[-1], sh.log2s)):
                    raise AssertionError(f"ring address of tap {a} off its index")
                ring[rho, fir_slot(-b, r)] = loads[-1]
                for k in range(r):
                    reads[:, k, a] = ring[rho, fir_slot(k - b, r)]
    return reads, loads


def worst_bank(addrs: np.ndarray) -> int:
    """The most distinct shared-memory words one of the 32 banks serves in a
    warp's load (1: conflict-free)."""
    addrs = np.asarray(addrs)
    return max(len(set(addrs[addrs % 32 == b].tolist())) for b in range(32))


def kernel_info(decim: int, num_taps: int, hist: int, halo: bool = False
                ) -> tuple[int, int, int]:
    """(registers, local-memory bytes, resident blocks per SM) of the K1 (or
    K20) instantiation that runs `decim` (on the card)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.check(_build.load().srcdsp_mixfir_info(int(halo), decim, num_taps, hist,
                                                  *map(ctypes.byref, out)), "mixfir_info")
    return tuple(v.value for v in out)


@dataclasses.dataclass(frozen=True)
class MixFirKernel:
    """Fused kernel + its layout contract (the JAX package's MixFirKernel)."""

    fn: Callable          # (words0, dwords, x) -> (yr, yi): [NT, OT] (C=1) or [C, NT, OT]
    num_taps: int
    decim: int
    out_tile: int
    b_rows: int
    hist: int             # HK: history samples callers must prepend
    device: torch.device

    def block_in(self) -> int:
        """Input block granularity (N must be a multiple of this)."""
        return self.b_rows * self.out_tile * self.decim


def _make(taps: np.ndarray, decim: int, num_channels: int, out_tile: int, b_rows: int,
          device, counter: str, single: bool) -> MixFirKernel:
    t = taps.shape[-1]
    hist = _round_up(t - 1, LANE)
    block = b_rows * out_tile * decim
    taps_t = torch.as_tensor(taps, device=resolve(device)).contiguous()

    def fn(words0, dwords, x):
        xc = x[None] if single else x
        check_planes(xc, num_channels, hist, block)
        if xc.device != taps_t.device:
            raise ValueError(f"x on {xc.device}, kernel built for {taps_t.device}")
        if cuda_or_cpu(xc):
            yr, yi = _mix_fir_cuda(words0, dwords, xc, taps_t, decim, out_tile, hist, counter)
        else:
            yr, yi = mix_fir_plain(words0, dwords, xc, taps_t, decim, out_tile, hist)
        return (yr[0], yi[0]) if single else (yr, yi)

    return MixFirKernel(fn=fn, num_taps=t, decim=decim, out_tile=out_tile, b_rows=b_rows,
                        hist=hist, device=taps_t.device)


def make_mix_fir_kernel(taps, decim: int, out_tile: int = 512, b_rows: int = 32,
                        device=None) -> MixFirKernel:
    """Single-channel K1: fn(word0, dword, x [2, HK+N]) -> (yr, yi) [NT, OT].

    The TPU version's precision, phasor, pipelined and interpret options shape
    only the Pallas lowering and have no counterpart here; b_rows keeps its
    meaning as the input granularity (N % (b_rows*out_tile*decim) == 0).
    """
    taps = np.asarray(taps, np.float32)
    return _make(taps, decim, 1, out_tile, b_rows, device, "mixfir", single=True)


def make_mix_fir_kernel_mc(taps, decim: int, num_channels: int, out_tile: int = 512,
                           b_rows: int = 8, device=None) -> MixFirKernel:
    """Multichannel K1: fn(words0 [C], dwords [C], x [C, 2, HK+N]) -> [C, NT, OT] x2.

    `taps` is [T] (shared) or [C, T] (one filter per channel).
    """
    taps = np.asarray(taps, np.float32)
    if taps.ndim == 2 and taps.shape[0] != num_channels:
        raise ValueError(f"per-channel taps {taps.shape} != C={num_channels}")
    return _make(taps, decim, num_channels, out_tile, b_rows, device, "mixfir_mc",
                 single=False)


def mix_fir_decim(kernel: MixFirKernel, word0, dword, x_planes: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes: [2, HK+N] f32 -> planes [1, N/M] (``mix_fir_decim_pallas``)."""
    yr, yi = kernel.fn(word0, dword, x_planes)
    return yr.reshape(1, -1), yi.reshape(1, -1)


def mix_fir_decim_mc(kernel: MixFirKernel, words0, dwords, x_planes: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes: [C, 2, HK+N] f32; words [C] u32 -> planes [C, N/M]
    (``mix_fir_decim_pallas_mc``)."""
    yr, yi = kernel.fn(words0, dwords, x_planes)
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)
