"""Fused NCO mix + rational L/M resampler, kernel K8 (counterpart of
``srcdsp_tpu/kernels/resample_pallas.py``).

With u the zero-stuffed upsample of the mixed input m,

    y[J] = sum_k h[k] u[J*M - k] = sum_g h[J*M + HX*L - g*L] m[g]

over the history-prepended input (g = 0 is the first of HX history samples).
The TPU kernel lays h out as a stride-L banded Toeplitz matrix
(`toeplitz_resample`, `banded_resample_taps`) and runs banded matmuls; the
CUDA kernel (``csrc/resample.cu``) computes the same sum in polyphase form:
output J reads the ceil(T/L) taps of one phase, phi = (J*M) mod L, against
the samples g = floor((J*M + HX*L)/L) - q, q ascending. No zero-stuffed
sample or zero band row is computed. The outputs of one class J mod L share
a phase and form a decimate-by-M FIR, which the kernel runs on the register
ring of ``csrc/fir_ring.cuh``; `ring_geometry` and the ``ring_*``/``class_*``
functions mirror its geometry, ownership, index map and output tile.

Layout (the JAX kernel's): x [C, 2, HX+NIN] f32 in, yr, yi [C, NT, OT] out,
HX = ceil((T-1)/L) rounded up to 128, NIN a multiple of
block_in() = b_rows*OT*M/L, and OT*M % L == 0. Each input sample is mixed by
its exact u32 word ``word0 + g*dword``, as in K1 (``kernels/mixfir``).

`combine_fir_resample_taps` folds a unit-rate FIR in front of the resampler
into one tap set, so config 2 (mix -> 128-tap FIR -> 3/4 resample) is one
launch of this kernel. On a CPU tensor the wrappers run `mix_resample_plain`,
which mixes as K1's plain version does and resamples with the fixed-order
polyphase sum of ``ops.resample``; on a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import (LANE, FirShape, _round_up, check_planes,
                                              cuda_or_cpu, fir_pad, fir_shape, host_words,
                                              mix_planes)
from srcdsp_tpu_torch.ops.resample import polyphase_resample

__all__ = ["ResampleKernel", "toeplitz_resample", "banded_resample_taps",
           "combine_fir_resample_taps", "make_mix_resample_kernel",
           "make_mix_resample_kernel_mc", "mix_resample", "mix_resample_mc",
           "mix_resample_plain", "resample_geometry", "phase_taps", "kernel_info"]


def toeplitz_resample(taps: np.ndarray, up: int, down: int, out_tile: int,
                      hist: int) -> np.ndarray:
    """H[a, j] = h[j*down + hist*up - a*up], zero outside [0, T)."""
    h = np.asarray(taps, np.float32)
    t = h.shape[0]
    span = (out_tile * down) // up + hist
    mat = np.zeros((span, out_tile), np.float32)
    for j in range(out_tile):
        base = j * down + hist * up
        for a in range(span):
            k = base - a * up
            if 0 <= k < t:
                mat[a, j] = h[k]
    return mat


def banded_resample_taps(taps, up: int, down: int, out_tile: int, hist: int,
                         block_cols: int) -> np.ndarray:
    """Per-block bands of `toeplitz_resample`: [NB, BC*down/up + hist, BC]."""
    ht = toeplitz_resample(taps, up, down, out_tile, hist)
    nb = out_tile // block_cols
    blk_stride = (block_cols * down) // up
    bspan = blk_stride + hist
    return np.stack([
        ht[j * blk_stride: j * blk_stride + bspan,
           j * block_cols: (j + 1) * block_cols]
        for j in range(nb)
    ])


def combine_fir_resample_taps(fir_taps, resample_taps, up: int) -> np.ndarray:
    """One tap set for a unit-rate FIR h1 followed by an L/M resampler h2:
    hc = h2 conv up_L(h1), of length len(h2) + L*(len(h1) - 1), made in
    float64 and rounded to float32 once (zero-stuffing commutes with
    convolution)."""
    h1 = np.asarray(fir_taps, np.float64)
    h2 = np.asarray(resample_taps, np.float64)
    h1u = np.zeros(up * (len(h1) - 1) + 1, np.float64)
    h1u[::up] = h1
    return np.convolve(h1u, h2).astype(np.float32)


def resample_geometry(num_taps: int, up: int, down: int, out_tile: int) -> tuple[int, int]:
    """(hist, row_stride): history samples HX = ceil((T-1)/L) rounded up to
    128, and input samples per output row OT*M/L (the JAX tiling check)."""
    if (out_tile * down) % up != 0:
        raise ValueError(f"out_tile*down = {out_tile}*{down} must be a multiple of up={up}")
    return _round_up(-(-(num_taps - 1) // up), LANE), (out_tile * down) // up


def phase_taps(taps: np.ndarray, up: int) -> np.ndarray:
    """Taps regrouped by phase for the kernel: P[phi, q] = h[phi + q*up],
    [up, ceil(T/up)], zero past the end of h."""
    h = np.asarray(taps, np.float32)
    q = -(-h.shape[0] // up)
    padded = np.zeros(up * q, np.float32)
    padded[:h.shape[0]] = h
    return np.ascontiguousarray(padded.reshape(q, up).T)


# The CUDA body's geometry, ownership, index map and output tile
# (csrc/resample.cu), mirrored item by item (file:line of each). The ring
# itself is kernels/mixfir.py's (ring_schedule with the class bases).
SMEM_BUDGET = 96 * 1024  # resample.cu kSmemBudget


class RingGeometry(NamedTuple):
    """resample.cu ResampleGeometry."""

    q: int          # taps a phase, ceil(T / L)
    tpc: int        # taps a class runs and floats of its row: Q in whole chunks
    lead: int       # window samples before the block's hist-th
    warps: int      # W: warps a class task spans (a power of two)
    nr: int         # outputs of one class a block owns: W*32*R
    outputs: int    # outputs a block owns: nr*L
    span: int       # window samples
    plane: int      # floats of one padded window plane
    out_plane: int  # floats of one plane of the output tile
    step: int       # classes a warp moves on by: warps a block / W


def ring_shape(down: int) -> FirShape:
    """resample.cu ResampleShape<D> = K1's FirShape<D> with D = down
    (by_decim: 1, 2 and 4 have their own instantiation, any other the
    generic one, R = 1)."""
    return fir_shape(down)


def class_offset(j, up: int, down: int):
    """o_j = floor(j*M / L): class j's outputs read o_j samples past class
    0's; the ring's static offset O (resample.cu class_ring)."""
    return j * down // up


def class_phase(j, up: int, down: int):
    """phi_j = (j*M) mod L, the row of phase_taps class j runs."""
    return j * down % up


def ring_smem(g: RingGeometry, up: int) -> int:
    """resample.cu resample_smem: bytes of shared memory a block uses."""
    return 4 * (up * g.tpc + 2 * g.plane + 2 * g.out_plane)


def ring_geometry(up: int, down: int, num_taps: int, hist: int) -> RingGeometry:
    """resample.cu resample_geometry."""
    sh = ring_shape(down)
    q = -(-num_taps // up)
    tpc = _round_up(q, sh.chunk if down in (1, 2, 4) else 4)
    lead = _round_up(max(tpc - 1, hist), 1 << sh.log2s) - hist
    warps = sh.threads // 32
    while True:
        nr = warps * 32 * sh.r
        span = nr * down + hist + lead
        g = RingGeometry(q, tpc, lead, warps, nr, nr * up, span,
                         fir_pad(span - 1, sh.log2s) + 1, nr * up + nr // sh.r,
                         sh.threads // 32 // warps)
        if warps == 1 or ring_smem(g, up) <= SMEM_BUDGET:
            return g
        warps //= 2


def class_tap_rows(taps, up: int, down: int, g: RingGeometry) -> np.ndarray:
    """resample.cu: the [L, tpc] tap rows a block stages; row j holds
    phase_taps row phi_j (Q taps), then zeros."""
    rows = np.zeros((up, g.tpc), np.float32)
    rows[:, :g.q] = phase_taps(taps, up)[class_phase(np.arange(up), up, down)]
    return rows


def ring_window_start(block: int, down: int, g: RingGeometry) -> int:
    """resample.cu: stream sample of window index 0 of `block`."""
    return block * g.nr * down - g.lead


def ring_tasks(up: int, down: int, g: RingGeometry) -> list:
    """resample.cu: (warp, class j, sub-block) in the order each warp takes
    its tasks, j = w/W + n*step, sub = w mod W (task j*W + sub = w + n*warps
    a block); lane l of the task owns r = (sub*32 + l)*R + k, k < R."""
    warps = ring_shape(down).threads // 32
    return [(w, j, w % g.warps) for w in range(warps)
            for j in range(w // g.warps, up, g.step)]


def ring_base(j: int, r0, up: int, down: int, hist: int, g: RingGeometry):
    """resample.cu: the window index output r0 of class j reads at tap 0 of
    its row, o_j past a multiple of R*M (the static instantiations' stride)."""
    return r0 * down + hist + g.lead + class_offset(j, up, down)


def ring_output(block: int, r, j, up: int, g: RingGeometry):
    """Output (flat over [NT, OT]) of output r of class j in `block`; one at
    or past NT*OT is not stored."""
    return block * g.outputs + r * up + j


def ring_tile_index(r, j, up: int, down: int):
    """resample.cu: the output tile's float of output r*L + j, r*L + j + r/R
    (one float of padding per R*L outputs; rs*(R*L + 1) + j at r = rs*R)."""
    return r * up + j + r // ring_shape(down).r


def ring_tile_read(i, up: int, down: int):
    """resample.cu: the tile float the store of the block's output i reads,
    i + i/(R*L)."""
    return i + i // (ring_shape(down).r * up)


def kernel_info(up: int, down: int, num_taps: int, hist: int, frames: bool = False,
                bf16: bool = False) -> tuple[int, int, int]:
    """(registers, local-memory bytes, resident blocks per SM) of the K8 (or,
    with frames, K9; bf16 read in pairs) instantiation that runs up/down (on
    the card)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.check(_build.load().srcdsp_resample_info(int(frames), int(bf16), up, down,
                                                    -(-num_taps // up), hist,
                                                    *map(ctypes.byref, out)), "resample_info")
    return tuple(v.value for v in out)


def mix_resample_plain(words0, dwords, x: torch.Tensor, taps, up: int, down: int,
                       out_tile: int, hist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K8: x [C, 2, hist+N] (f32 or bf16) -> yr, yi [C, NT, OT] f32.

    Every output is the same fixed-order sum whatever block it falls in, so
    chunked calls join bit for bit.
    """
    c = x.shape[0]
    y = polyphase_resample(mix_planes(words0, dwords, x), taps, up, down, hist)
    return y[:, 0].reshape(c, -1, out_tile), y[:, 1].reshape(c, -1, out_tile)


def _mix_resample_cuda(words0, dwords, x: torch.Tensor, taps_ph: torch.Tensor, up: int,
                       down: int, out_tile: int, hist: int, counter: str
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load()
    c, _, length = x.shape
    nt = (length - hist) * up // (down * out_tile)
    w0, dw = host_words(words0, c), host_words(dwords, c)
    yr = torch.empty((c, nt, out_tile), dtype=torch.float32, device=x.device)
    yi = torch.empty_like(yr)
    rc = lib.srcdsp_mix_resample(x.data_ptr(), taps_ph.data_ptr(), yr.data_ptr(),
                                 yi.data_ptr(), w0.ctypes.data, dw.ctypes.data, c, length,
                                 nt, out_tile, up, down, taps_ph.shape[1], hist,
                                 _build.stream_handle(x))
    _build.check(rc, counter)
    _build.LAUNCHES[counter] += 1
    return yr, yi


@dataclasses.dataclass(frozen=True)
class ResampleKernel:
    """Fused mix + resample kernel + its layout contract (the JAX package
    returns a MixFirKernel with decim=down and in_block set)."""

    fn: Callable          # (words0, dwords, x) -> (yr, yi): [NT, OT] (C=1) or [C, NT, OT]
    num_taps: int
    up: int
    down: int
    out_tile: int
    b_rows: int
    hist: int             # HX: history samples callers must prepend
    device: torch.device

    def block_in(self) -> int:
        """Input block granularity (NIN must be a multiple of this)."""
        return self.b_rows * self.out_tile * self.down // self.up


def _make(taps, up: int, down: int, num_channels: int, out_tile: int, b_rows: int, device,
          counter: str, single: bool) -> ResampleKernel:
    taps = np.asarray(taps, np.float32)
    t = taps.shape[0]
    hist, row_stride = resample_geometry(t, up, down, out_tile)
    block = b_rows * row_stride
    dev = resolve(device)
    taps_t = torch.as_tensor(taps, device=dev)
    taps_ph = torch.as_tensor(phase_taps(taps, up), device=dev)

    def fn(words0, dwords, x):
        xc = x[None] if single else x
        check_planes(xc, num_channels, hist, block)
        if xc.device != dev:
            raise ValueError(f"x on {xc.device}, kernel built for {dev}")
        if cuda_or_cpu(xc):
            yr, yi = _mix_resample_cuda(words0, dwords, xc, taps_ph, up, down, out_tile,
                                        hist, counter)
        else:
            yr, yi = mix_resample_plain(words0, dwords, xc, taps_t, up, down, out_tile, hist)
        return (yr[0], yi[0]) if single else (yr, yi)

    return ResampleKernel(fn=fn, num_taps=t, up=up, down=down, out_tile=out_tile,
                          b_rows=b_rows, hist=hist, device=dev)


def make_mix_resample_kernel(taps, up: int, down: int, out_tile: int = 512, b_rows: int = 8,
                             device=None) -> ResampleKernel:
    """Single-channel K8: fn(word0, dword, x [2, HX+NIN]) -> (yr, yi) [NT, OT].

    The TPU version's block_cols, precision, hist_round, pipelined and
    interpret options shape only the Pallas lowering and have no counterpart
    here; b_rows keeps its meaning as the input granularity.
    """
    return _make(taps, up, down, 1, out_tile, b_rows, device, "mix_resample", single=True)


def make_mix_resample_kernel_mc(taps, up: int, down: int, num_channels: int,
                                out_tile: int = 512, b_rows: int = 8,
                                device=None) -> ResampleKernel:
    """Multichannel K8, shared taps and per-channel words:
    fn(words0 [C], dwords [C], x [C, 2, HX+NIN]) -> (yr, yi) [C, NT, OT]."""
    return _make(taps, up, down, num_channels, out_tile, b_rows, device, "mix_resample_mc",
                 single=False)


def mix_resample(kernel: ResampleKernel, word0, dword, x_planes: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes: [2, HX+NIN] f32 -> planes [1, NIN*up/down] (``mix_resample_pallas``)."""
    yr, yi = kernel.fn(word0, dword, x_planes)
    return yr.reshape(1, -1), yi.reshape(1, -1)


def mix_resample_mc(kernel: ResampleKernel, words0, dwords, x_planes: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes: [C, 2, HX+NIN] f32; words [C] u32 -> planes [C, NIN*up/down]
    (``mix_resample_pallas_mc``)."""
    yr, yi = kernel.fn(words0, dwords, x_planes)
    c = yr.shape[0]
    return yr.reshape(c, -1), yi.reshape(c, -1)
