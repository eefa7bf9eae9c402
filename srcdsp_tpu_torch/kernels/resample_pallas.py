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
sample or zero band row is computed.

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

import dataclasses
from typing import Callable

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import LANE, _round_up, check_planes, cuda_or_cpu, mix_planes
from srcdsp_tpu_torch.ops.nco import word_tensor
from srcdsp_tpu_torch.ops.resample import polyphase_resample

__all__ = ["ResampleKernel", "toeplitz_resample", "banded_resample_taps",
           "combine_fir_resample_taps", "make_mix_resample_kernel",
           "make_mix_resample_kernel_mc", "mix_resample", "mix_resample_mc",
           "mix_resample_plain", "resample_geometry", "phase_taps"]


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


def mix_resample_plain(words0, dwords, x: torch.Tensor, taps, up: int, down: int,
                       out_tile: int, hist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K8: x [C, 2, hist+N] (f32 or bf16) -> yr, yi [C, NT, OT] f32.

    Every output is the same fixed-order sum whatever block it falls in, so
    chunked calls join bit for bit.
    """
    c = x.shape[0]
    y = polyphase_resample(mix_planes(words0, dwords, x), taps, up, down, hist)
    return y[:, 0].reshape(c, -1, out_tile), y[:, 1].reshape(c, -1, out_tile)


def _host_words(words, c: int) -> np.ndarray:
    """u32 words as a host uint32 array [C] for the kernel's by-value words."""
    w = word_tensor(words).reshape(-1).expand(c).cpu().numpy()
    return np.ascontiguousarray(w.astype(np.uint32))


def _mix_resample_cuda(words0, dwords, x: torch.Tensor, taps_ph: torch.Tensor, up: int,
                       down: int, out_tile: int, hist: int, counter: str
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    lib = _build.load()
    c, _, length = x.shape
    nt = (length - hist) * up // (down * out_tile)
    w0, dw = _host_words(words0, c), _host_words(dwords, c)
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
