"""Row-form fused NCO mix + FIR + decimate, kernel K18 (counterpart of
``srcdsp_tpu/kernels/mixfir_rows.py``).

The history-prepended planes are viewed as [2, R, 128] rows. Because
OT*decim is a multiple of 128, every output row's window is whole rows of
that view. Each input sample is mixed once, by the factored phasor

    e^{j 2 pi (word0 + (row*128 + lane)*dword) / 2^32}
      = e^{j 2 pi (word0 + row*128*dword) / 2^32} * e^{j 2 pi lane*dword / 2^32}

(two phasors per 128 samples where K1 makes one per sample), with the row
words in u32 wrap, the JAX kernel's int32 wrap. The FIR is K1's real-tap sum.
The CUDA kernel is ``csrc/rows.cu``: K1's register ring over the flat stream,
its window staged with the factored mix (`rows_window` mirrors a block's
staging); the TPU kernel's chunked [B, 128] x [128, BC] matmuls are a
matrix-unit lowering with no counterpart here. The output equals K1's to
float32 rounding of the phasor product, not to the bit. On a CPU tensor the
wrapper runs `mix_fir_rows_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from srcdsp_tpu_torch.device import resolve
from srcdsp_tpu_torch.kernels import _build
from srcdsp_tpu_torch.kernels.mixfir import (
    LANE, _round_up, check_f32_operand, fir_base, fir_decim_rows, fir_geometry, fir_shape,
    fir_window_start, signed_phase_angle)
from srcdsp_tpu_torch.kernels.mixfir_ctaps import word_u32
from srcdsp_tpu_torch.ops.nco import MASK32

__all__ = ["MixFirRowsKernel", "make_mix_fir_rows_kernel", "mix_fir_rows",
           "mix_fir_rows_plain", "rows_view", "rows_window"]


@dataclasses.dataclass(frozen=True)
class MixFirRowsKernel:
    """K18 + its layout contract (the JAX package's MixFirRowsKernel)."""

    fn: Callable          # (word0, dword, x [2, R, 128], n=None) -> (yr, yi) [NT, OT]
    num_taps: int
    decim: int
    out_tile: int
    b_rows: int
    hist: int

    def block_in(self) -> int:
        """Input block granularity (N must be a multiple of this)."""
        return self.b_rows * self.out_tile * self.decim


def phasors(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of u32 words read as signed turns (the plain version's)."""
    a = signed_phase_angle(words)
    return torch.cos(a), torch.sin(a)


def rows_phasors(word0, dword, nrows: int, device=None) -> tuple[torch.Tensor, ...]:
    """The plain factored phasors: (cos, sin) of row r's word word0 +
    r*(128*dword) for r < nrows, then (cos, sin) of lane l's word l*dword for
    l < 128 (u32 wrap)."""
    dw = word_u32(dword)
    rows = torch.arange(nrows, dtype=torch.int64, device=device)
    lanes = torch.arange(LANE, dtype=torch.int64, device=device)
    return (*phasors((word_u32(word0) + rows * ((LANE * dw) & MASK32)) & MASK32),
            *phasors((lanes * dw) & MASK32))


def rows_mix_plain(word0, dword, x: torch.Tensor) -> torch.Tensor:
    """The plain factored mix of x [2, R, 128] -> u [2, R*128]: c = cr*cl -
    sr*sl, s = cr*sl + sr*cl, u = (xr*c - xi*s, xr*s + xi*c)."""
    crow, srow, clane, slane = rows_phasors(word0, dword, x.shape[1], x.device)
    crow, srow, clane, slane = crow[:, None], srow[:, None], clane[None, :], slane[None, :]
    c = crow * clane - srow * slane
    s = crow * slane + srow * clane
    xr, xi = x[0], x[1]
    return torch.stack([xr * c - xi * s, xr * s + xi * c]).reshape(2, -1)


def mix_fir_rows_plain(word0, dword, x: torch.Tensor, taps: torch.Tensor, decim: int,
                       out_tile: int, hist: int, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K18: the factored phasor over x [2, R, 128], then the
    real-tap FIR of the first hist + n samples -> yr, yi [NT, OT]."""
    u = rows_mix_plain(word0, dword, x)[:, :hist + n]
    y = fir_decim_rows(u[None], taps, decim, hist)[0]
    return y[0].reshape(-1, out_tile), y[1].reshape(-1, out_tile)


def kernel_info(decim: int, num_taps: int, hist: int) -> tuple[int, int, int]:
    """(registers, local-memory bytes, resident blocks per SM) of the K18
    instantiation that runs `decim` (on the card)."""
    out = [ctypes.c_int(0) for _ in range(3)]
    _build.check(_build.load().srcdsp_mixfir_rows_info(decim, num_taps, hist,
                                                       *map(ctypes.byref, out)),
                 "mixfir_rows_info")
    return tuple(v.value for v in out)


def make_mix_fir_rows_kernel(taps, decim: int, out_tile: int = 512, b_rows: int = 32,
                             block_cols: int = 128, device=None) -> MixFirRowsKernel:
    """Build K18: fn(word0, dword, x [2, R, 128] f32, n=None) -> (yr, yi) [NT, OT].

    Keeps the reference's layout contract: out_tile*decim and
    block_cols*decim multiples of 128, out_tile % block_cols == 0, N a
    multiple of b_rows*out_tile*decim, and R at least the rows its last slab
    would read (pad the tail; `mix_fir_rows` does). n defaults to R*128 -
    hist. The TPU version's precision and interpret options shape only the
    Pallas lowering and have no counterpart here.
    """
    taps_t = torch.as_tensor(np.asarray(taps, np.float32), device=resolve(device)).contiguous()
    if (out_tile * decim) % LANE != 0:
        raise ValueError(f"out_tile*decim must be a multiple of {LANE}")
    if (block_cols * decim) % LANE != 0:
        raise ValueError(f"block_cols*decim must be a multiple of {LANE}")
    if out_tile % block_cols != 0:
        raise ValueError(f"out_tile {out_tile} % block_cols {block_cols}")
    t = taps_t.shape[0]
    hist = _round_up(t - 1, LANE)
    span = out_tile * decim + hist
    rs8 = (out_tile * decim) // LANE
    slab_rows = _round_up((b_rows - 1) * rs8 + span // LANE + 1, math.lcm(8, rs8))

    def fn(word0, dword, x, n=None):
        two, r, lane = x.shape
        if two != 2 or lane != LANE:
            raise ValueError(f"x must be [2, R, {LANE}], got {tuple(x.shape)}")
        if n is None:
            n = r * LANE - hist     # no tail padding
        block = b_rows * out_tile * decim
        if n <= 0 or n % block != 0:
            raise ValueError(f"N={n} not a multiple of {block}")
        nt = n // (out_tile * decim)
        grid = nt // b_rows
        if (grid - 1) * b_rows * rs8 + slab_rows > r:
            raise ValueError(f"need R >= {(grid - 1) * b_rows * rs8 + slab_rows} rows "
                             f"(pad the tail), got {r}")
        if not check_f32_operand(x, taps_t.device, "x"):
            return mix_fir_rows_plain(word0, dword, x, taps_t, decim, out_tile, hist, n)
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        lib = _build.load()
        yr = torch.empty((nt, out_tile), dtype=torch.float32, device=x.device)
        yi = torch.empty_like(yr)
        rc = lib.srcdsp_mixfir_rows(x.data_ptr(), taps_t.data_ptr(), yr.data_ptr(),
                                    yi.data_ptr(), word_u32(word0), word_u32(dword), r * LANE,
                                    nt, out_tile, decim, t, hist, _build.stream_handle(x))
        _build.check(rc, "mixfir_rows")
        _build.LAUNCHES["mixfir_rows"] += 1
        return yr, yi

    return MixFirRowsKernel(fn=fn, num_taps=t, decim=decim, out_tile=out_tile,
                            b_rows=b_rows, hist=hist)


def rows_view(kernel: MixFirRowsKernel, x_planes: torch.Tensor) -> tuple[torch.Tensor, int]:
    """x_planes [2, HK+N] -> (x [2, R, 128], N): the tail zero-padded to the
    kernel's slab-row rounding, as ``mix_fir_rows_pallas`` pads it."""
    total = x_planes.shape[-1]
    n = total - kernel.hist
    rs8 = (kernel.out_tile * kernel.decim) // LANE
    span_rows = (kernel.out_tile * kernel.decim + kernel.hist) // LANE
    grid = n // kernel.block_in()
    need_rows = _round_up((grid - 1) * kernel.b_rows * rs8
                          + _round_up((kernel.b_rows - 1) * rs8 + span_rows + 1, 8), 8)
    pad = need_rows * LANE - total
    if pad > 0:
        x_planes = torch.cat([x_planes, x_planes.new_zeros((2, pad))], dim=-1)
    return x_planes.reshape(2, -1, LANE), n


def _mul_u32(a: np.ndarray, w: int) -> np.ndarray:
    """a * w mod 2^32 for non-negative int64 a < 2^32 (uint64 wraps mod 2^64)."""
    return (a.astype(np.uint64) * np.uint64(w) & np.uint64(MASK32)).astype(np.int64)


def rows_window(kernel: MixFirRowsKernel, block: int, word0, dword, x: np.ndarray,
                tables: tuple[np.ndarray, ...]) -> dict[str, np.ndarray]:
    """What K18's `block` stages (rows.cu:70-100, RowMix :42-58), in numpy.

    Window index i holds stream sample g = start + i, start = the block's
    first output * decim - lead (K1's window); the sample is mixed by row
    phasor k = (g >> 7) - row0 of the block's table (row0 = start >> 7, k <
    span/128 + 2, word w0 + u32((row0 + k)*128)*dw) and lane phasor g & 127
    (word (g & 127)*dw), and staged as zero where Planes has no sample (g < 0
    or g >= R*128). x: the view [2, R, 128] float32; tables: the plain
    version's `rows_phasors` over R rows as numpy, looked up at the kernel's
    row and lane, so `staged` [2, span] is the kernel's arithmetic on the
    plain version's phasors: c = cr*cl - sr*sl, s = cr*sl + sr*cl, (a*c - b*s,
    a*s + b*c), each product and sum rounded to float32. Returns g, row, lane,
    row_words, lane_words, loaded and staged; nrows is the table's length.
    """
    _, lead, span, _ = fir_geometry(kernel.decim, kernel.num_taps, kernel.hist)
    start = fir_window_start(block, kernel.decim, lead)
    row0 = start >> 7
    g = start + np.arange(span, dtype=np.int64)
    row, lane = (g >> 7) - row0, g & (LANE - 1)
    w0, dw = word_u32(word0), word_u32(dword)
    total = x.shape[1] * LANE
    loaded = (g >= 0) & (g < total)
    at = np.where(loaded, g, 0)
    crow, srow, clane, slane = tables
    cr, sr = crow[at >> 7], srow[at >> 7]
    cl, sl = clane[lane], slane[lane]
    c = cr * cl - sr * sl
    s = cr * sl + sr * cl
    a, b = x.reshape(2, -1)[:, at]
    staged = np.where(loaded, np.stack([a * c - b * s, a * s + b * c]), np.float32(0))
    row_words = (w0 + _mul_u32(((row0 + row) * LANE) & MASK32, dw)) & MASK32
    return dict(g=g, row=row, lane=lane, nrows=np.int64(span // LANE + 2), row_words=row_words,
                lane_words=_mul_u32(lane, dw), loaded=loaded, staged=staged)


def rows_outputs(kernel: MixFirRowsKernel, block: int) -> tuple[np.ndarray, np.ndarray]:
    """rows.cu:103-104: (J, e) [threads, R] of K18's `block`: output J =
    block*kOutputs + tid*R + k reads window index e - a at tap a."""
    sh = fir_shape(kernel.decim)
    _, lead, _, _ = fir_geometry(kernel.decim, kernel.num_taps, kernel.hist)
    tid = np.arange(sh.threads)[:, None]
    k = np.arange(sh.r)[None, :]
    return (block * sh.outputs + tid * sh.r + k,
            fir_base(tid, kernel.decim, kernel.hist, lead) + k * kernel.decim)


def mix_fir_rows(kernel: MixFirRowsKernel, word0, dword, x_planes: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_planes [2, HK+N] f32 -> planes [1, N/M] (``mix_fir_rows_pallas``)."""
    x3, n = rows_view(kernel, x_planes)
    yr, yi = kernel.fn(word0, dword, x3, n=n)
    return yr.reshape(1, -1), yi.reshape(1, -1)
